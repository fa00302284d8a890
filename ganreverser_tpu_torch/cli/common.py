"""Shared CLI glue: device selection, compute dtype, multi-process start-up
and the mesh, models and train states <-> checkpoint trees, the dataset,
host images for artifacts."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import parallel as par
from ..core.platform import resolve_device  # noqa: F401
from ..core.prng import INIT_STAGE, stage_generator
from ..data.colorspace import to_rgb
from ..data.dataset import Dataset
from ..io.metrics import MetricsWriter
from ..models import bridge, zoo
from ..models.modules import init_parameters, set_data_parallel
from ..optim import Optimizer, make_optimizer
from ..train.state import GanState, TrainState

# the directory that holds the package, for the ranks a CLI starts
_ROOT = str(Path(__file__).resolve().parents[2])


def compute_dtype(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        getattr(cfg, "compute_dtype", "float32")]


def maybe_distributed(cfg) -> bool:
    """Join the process group when --coordinator_address (or torchrun's
    environment) says so; before any device use (parallel/multihost.py)."""
    started = par.initialize_distributed(
        getattr(cfg, "coordinator_address", ""),
        getattr(cfg, "num_processes", 0), getattr(cfg, "process_id", -1))
    if started:
        rank, n = par.mesh.world()
        print(f"<trainer> joined distributed runtime: process {rank}/{n}")
    return started


def wants_mesh(cfg) -> bool:
    """Whether the flags or the process group ask for a mesh."""
    return (cfg.mesh_data != 1 or cfg.mesh_model != 1
            or par.mesh.world()[1] > 1)


def place_gan_on_mesh(gs: GanState, mesh: par.Mesh) -> GanState:
    """G and D on the mesh (JAX's place_gan_on_mesh): module state
    replicated from rank 0, BatchNorm and dropouts set for rows of a batch
    cut over 'data', and with a 'model' axis only this rank's slices of the
    parameters and of the optimizer state kept."""
    for ts in (gs.g, gs.d):
        for name, buf in par.replicate(dict(ts.module.named_buffers()),
                                       mesh).items():
            ts.module.get_buffer(name).copy_(buf)
        set_data_parallel(ts.module, mesh)
        if mesh.shape[par.MODEL_AXIS] > 1:
            ts.shard_model_axis(mesh)
    return gs


class SilentWriter:
    """The metrics writer of a rank other than 0: it records nothing, as
    only rank 0 writes files."""

    def scalar(self, *args, **kwargs):
        pass

    def image_grid(self, *args, **kwargs):
        pass

    def chart(self, *args, **kwargs):
        pass

    def close(self):
        pass


def make_writer(save: str, name: str = "events"):
    """A MetricsWriter on rank 0, a SilentWriter on the other ranks."""
    return MetricsWriter(save, name) if par.is_main_process() else \
        SilentWriter()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(module: str, argv: list, n: int) -> None:
    """Run ``python -m module argv`` as ``n`` ranks on this host, joined
    over a localhost rendezvous by torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE).
    Waits for all; when one fails the others are killed and SystemExit
    names it. The kernels are built here first, so that the ranks load
    one library rather than each building it."""
    if resolve_device().type == "cuda":
        from ..ops import cuda_lib
        cuda_lib.library()
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                   PYTHONPATH=os.pathsep.join(
                       p for p in (_ROOT, os.environ.get("PYTHONPATH"))
                       if p))
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv],
                                      env=env))
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = next(((r, c) for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is not None or all(c == 0 for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed is not None:
        sys.exit(f"{module}: rank {failed[0]} of {n} exited with code "
                 f"{failed[1]}")


def ts_to_tree(ts: TrainState) -> dict:
    """The JAX package's train-state tree (its cli/common.py::ts_to_tree):
    ``{"params", "state", "opt_state", "step"}``, the optimizer's
    per-parameter lists nested like the params, the step counts int32.
    With 'model' shards the whole leaves are gathered first (a collective:
    every rank of the group must call it)."""
    with par.whole_params(ts):
        names = [n for n, _ in ts.module.named_parameters()]
        variables = bridge.export_variables(ts.module)
    opt_state = {k: (bridge.nest_by_name(dict(zip(names, v)))
                     if isinstance(v, list) else bridge.leaf_array(v))
                 for k, v in ts.whole_opt_state().items()}
    return {"params": variables["params"], "state": variables["state"],
            "opt_state": opt_state, "step": bridge.leaf_array(ts.step)}


def ts_from_tree(tree: dict, module: torch.nn.Module, opt: Optimizer,
                 device: torch.device) -> TrainState:
    """The inverse: loads ``tree`` (written by either package) into
    ``module`` on ``device`` and ``opt``'s state; raises when the tree's
    optimizer state has other keys than ``opt`` keeps."""
    bridge.load_jax_variables(module, tree)
    module.to(device)
    names = [n for n, _ in module.named_parameters()]
    opt_state = opt.init(list(module.parameters()))
    if set(tree["opt_state"]) != set(opt_state):
        raise ValueError(f"checkpoint optimizer state {sorted(tree['opt_state'])}"
                         f" does not match {sorted(opt_state)}")
    for k, v in opt_state.items():
        if isinstance(v, list):
            opt_state[k] = bridge.take_by_name(tree["opt_state"][k], names,
                                               device)
        else:
            opt_state[k] = bridge.to_torch(tree["opt_state"][k], device)
    return TrainState(module=module, opt_state=opt_state,
                      step=int(tree["step"]))


def gan_optimizers(cfg) -> tuple:
    """(G's, D's) optimizers from the flags (adversarial.lua:147-188)."""
    return (make_optimizer(cfg.G_optmethod, sgd_lr=cfg.G_sgd_lr,
                           sgd_momentum=cfg.G_sgd_momentum),
            make_optimizer(cfg.D_optmethod, sgd_lr=cfg.D_sgd_lr,
                           sgd_momentum=cfg.D_sgd_momentum))


def build_gan_models(cfg, dtype: torch.dtype):
    """(G3, D2, dims) for the flags' geometry and ``--init``, weights
    zero, in evaluation."""
    dims = cfg.img_dims()
    init = getattr(cfg, "init", "heuristic")
    return (zoo.create_G(dims, cfg.noiseDim, dtype, init),
            zoo.create_D(dims, dtype, init), dims)


def init_gan_state(cfg, G, D, device: torch.device) -> GanState:
    """G and D with fresh weights by their layers' init schemes (G's drawn
    first, then D's, from the init stage of ``--seed``, on the CPU) and
    fresh optimizer states, on ``device``."""
    gen = stage_generator(cfg.seed, INIT_STAGE, "cpu")
    g_opt, d_opt = gan_optimizers(cfg)
    return GanState(
        g=TrainState.create(init_parameters(G, gen).to(device), g_opt),
        d=TrainState.create(init_parameters(D, gen).to(device), d_opt))


def gan_to_tree(gs: GanState, extra_arrays: dict | None = None) -> dict:
    """The JAX package's G/D checkpoint tree, ``{"G", "D"}`` train-state
    trees plus ``extra_arrays`` (``vis_noise_inputs``)."""
    tree = {"G": ts_to_tree(gs.g), "D": ts_to_tree(gs.d)}
    if extra_arrays:
        tree.update({k: bridge.leaf_array(v) for k, v in extra_arrays.items()})
    return tree


def gan_from_tree(tree: dict, G, D, g_opt: Optimizer, d_opt: Optimizer,
                  device: torch.device) -> GanState:
    """The inverse: ``tree["G"]``/``tree["D"]`` into the modules and the
    optimizers' states on ``device``."""
    return GanState(g=ts_from_tree(tree["G"], G, g_opt, device),
                    d=ts_from_tree(tree["D"], D, d_opt, device))


def make_dataset(cfg) -> Dataset:
    """The flags' dataset; the numpy stream is seeded ``--seed`` on every
    rank, which loads the whole epoch and trains on its rows (the JAX
    package seeds ``--seed`` + 7919 per process, each loading its share)."""
    if cfg.dataset == "NONE":
        sys.exit("--dataset is required (a directory of *.jpg images, or "
                 "'synthetic' for the built-in procedural faces)")
    return Dataset([cfg.dataset], height=cfg.height, width=cfg.width,
                   colorspace=cfg.colorSpace, seed=cfg.seed,
                   decode_draft=not getattr(cfg, "exact_decode", False),
                   cache_dir=getattr(cfg, "decode_cache", "") or None)


def to_nhwc_rgb(images: torch.Tensor, colorspace: str) -> np.ndarray:
    """Device NHWC images (any colour space) as host RGB f32."""
    return to_rgb(images.float().cpu().numpy(), colorspace)
