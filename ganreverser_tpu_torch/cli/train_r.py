"""Reverser training CLI — train_r.lua, the counterpart of
ganreverser_tpu/cli/train_r.py, in its order and with its artifact names.

Loads the frozen G (the module G3 in evaluation, run under ``no_grad``)
from its checkpoint and inherits noiseDim, noiseMethod, height, width and
colorSpace from the config saved with it (train_r.lua:71-75); creates R
(``--fixer`` adds the always-on input dropout) or continues one
(``--cont``); then trains on synthetic pairs, z -> G(z) -> R -> MSE(R(G(z)),
z), L1 -> L2 -> clamp, adam, in segments up to the next boundary:

  every 100 batches   r_loss_low/avg/high in <save>/events_r.jsonl, the
                      "Example:" printout, <save>/images_r/plot_r_loss.png
  every 25 batches    the G -> R -> G preview <save>/images_r/g_r_g_<b>.png
  every saveFreq      the checkpoint <save>/r_<C>x<H>x<W>_nd<z>_<method>
                      [_fixer] with extra {"batch", "plot_data"}

``r_batch_time`` (mean seconds per batch over 100) goes to the same event
file. On CUDA (GANREVERSER_PLATFORM unset or gpu) ``--dropout kernel`` runs
R's dropouts on kernel B5, forward and backward; with
GANREVERSER_PLATFORM=cpu the kernel's plain version runs.
``--async_save`` writes the checkpoints in a background thread.

Several processes (``--coordinator_address/--num_processes/--process_id``
or torchrun) train one R on a ('data', 'model') mesh (``--mesh_data``,
``--mesh_model``, parallel/): every rank draws each batch's latents as one
process would and trains on its rows, the gradients averaged over 'data',
so the run equals the one-process run. ``--dropout kernel`` stays on
kernel B5 on every rank, each rank's masks the rows of the whole batch's
(the counter base, ops/dropout_kernel.py; the JAX package draws threefry
masks under a mesh). A 'model' axis keeps each rank's slices of R's and
G's parameters and of the moments. Rank 0 alone writes files; the
"Example:" printout and the previews are skipped in a multi-process run,
as in the JAX package.

Usage: python -m ganreverser_tpu_torch.cli.train_r --G logs/adversarial \\
           --nbBatches 2000 --compute_dtype bfloat16 --dropout kernel
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import parallel as par
from ..core.config import RConfig
from ..core.prng import (INIT_STAGE, PREVIEW_STAGE, noise_inputs,
                         stage_generator, trainer_generators)
from ..io import checkpoint as ckpt
from ..io.metrics import StepTimer
from ..io.preemption import PreemptionGuard
from ..models import zoo
from ..models.bridge import load_jax_variables
from ..models.modules import (init_parameters, set_data_parallel,
                              set_dropout_generator)
from ..optim import adam
from ..train.r_loop import make_r_eval_step, make_r_segment_program
from ..train.state import TrainState
from . import common

DROPOUT_IMPLS = {"threefry": "plain", "kernel": "kernel"}


def _check_flags(cfg: RConfig):
    if cfg.dropout not in DROPOUT_IMPLS:
        sys.exit(f"--dropout {cfg.dropout!r}: expected threefry or kernel")


def _fmt10(v: torch.Tensor) -> str:
    return " ".join(f"{float(x):.2f}" for x in v[:10].float().cpu())


def main(argv=None) -> dict:
    """Train R; returns the train state and the per-batch losses of this
    run (a host list)."""
    cfg = RConfig.from_args(argv, "Reverser training (train_r.lua)")
    _check_flags(cfg)
    started = common.maybe_distributed(cfg)
    try:
        return _train_r(cfg)
    finally:
        ckpt.wait_for_saves()  # join an in-flight async write before exit
        if started:
            par.shutdown_distributed()


def _train_r(cfg: RConfig) -> dict:
    device = common.resolve_device()
    dtype = common.compute_dtype(cfg)
    print(f"<trainer> --prng {cfg.prng}: the port draws latents, dropouts "
          "and previews from torch generators seeded by --seed, whatever "
          "--prng says")

    # load frozen G, inherit geometry from its checkpoint (train_r.lua:66-75)
    g_tree, g_cfg, _ = ckpt.load_checkpoint(cfg.G)
    cfg.noiseDim = g_cfg["noiseDim"]
    cfg.noiseMethod = g_cfg["noiseMethod"]
    cfg.height = g_cfg["height"]
    cfg.width = g_cfg["width"]
    cfg.colorSpace = g_cfg["colorSpace"]
    dims = cfg.img_dims()
    c, h, w = dims
    G = load_jax_variables(zoo.create_G(dims, cfg.noiseDim, dtype),
                           g_tree["G"]).to(device)

    R = zoo.create_R(dims, cfg.noiseDim, cfg.noiseMethod, fixer=cfg.fixer,
                     dtype=dtype, dropout_impl=DROPOUT_IMPLS[cfg.dropout])
    opt = adam()
    cont_plot_data: list = []
    if cfg.cont:
        r_tree, _, cont_extra = ckpt.load_checkpoint(cfg.cont)
        ts = common.ts_from_tree(r_tree["R"], R, opt, device)
        # loss-history continuity across --cont (the reference saves only
        # {R, opt}, train_r.lua:234)
        cont_plot_data = list(cont_extra.get("plot_data", []))
        print(f"<trainer> continuing R from {cfg.cont} at step {ts.step}")
    else:
        init_parameters(R, stage_generator(cfg.seed, INIT_STAGE, "cpu"))
        ts = TrainState.create(R.to(device), opt)

    print(f"Number of free parameters in G: "
          f"{sum(p.numel() for p in G.parameters())}")
    print(f"Number of free parameters in R: "
          f"{sum(p.numel() for p in R.parameters())}")

    multi = par.mesh.world()[1] > 1
    mesh = g_shards = None
    if common.wants_mesh(cfg):
        # dp over the synthetic batch + tp over the big kernels
        mesh = par.make_mesh(data=cfg.mesh_data, model=cfg.mesh_model)
        print(f"<trainer> mesh: {mesh.shape}")
        set_data_parallel(R, mesh)
        if mesh.shape[par.MODEL_AXIS] > 1:
            ts.shard_model_axis(mesh)
            g_shards = par.ModelShards(G, mesh)

    noise_gen, drop_gen = trainer_generators(cfg.seed, device)
    preview_gen = stage_generator(cfg.seed, PREVIEW_STAGE, device)
    set_dropout_generator(R, drop_gen)
    invert = make_r_eval_step(R, fixer=cfg.fixer)

    def roundtrip(z):
        """G(z) -> R -> G, R in evaluation (the fixer's input dropout
        draws from the preview generator, so previews leave the training
        masks alone)."""
        with torch.no_grad():
            imgs = G(z)
            z_hat = invert(imgs, preview_gen)
            fixed = G(z_hat)
        set_dropout_generator(R, drop_gen)
        return imgs, z_hat, fixed

    writer = common.make_writer(cfg.save, name="events_r")
    timer = StepTimer(writer, log_every=100, tag="r_batch_time")
    guard = PreemptionGuard()  # SIGTERM -> checkpoint + clean exit
    ckpt_path = ckpt.r_name(cfg.save, c, h, w, cfg.noiseDim, cfg.noiseMethod,
                            cfg.fixer)
    last_saved = None

    def save():
        nonlocal last_saved
        last_saved = ts.step
        # every rank gathers (a collective with 'model' shards), then only
        # rank 0 writes
        tree = {"R": common.ts_to_tree(ts)}
        if not par.is_main_process():
            return
        saver = (ckpt.save_checkpoint_async if cfg.async_save
                 else ckpt.save_checkpoint)
        saver(ckpt_path, tree, config=cfg.to_dict(),
              extra={"batch": ts.step, "plot_data": plot_data})
        print(f"<trainer> saving network to {ckpt_path}")

    # batches run in segments up to the next print/preview/save boundary,
    # with one host fetch of the segment's losses (train/r_loop.py)
    segment = make_r_segment_program(
        G, batch_size=cfg.batchSize, noise_dim=cfg.noiseDim,
        noise_method=cfg.noiseMethod, dtype=dtype, mesh=mesh,
        g_shards=g_shards, r_l1=cfg.R_L1, r_l2=cfg.R_L2, r_clamp=cfg.R_clamp)
    cadences = [100, cfg.saveFreq] + ([] if cfg.noplot else [25])

    def next_boundary(i):
        cands = [((i + k - 1) // k) * k for k in cadences if k > 0]
        if cfg.nbBatches >= 0:
            cands.append(cfg.nbBatches)
        return min(k for k in cands if k >= i)

    losses: list = []
    # [batch, low, avg, high] rows (train_r.lua:192-204); under --cont the
    # new rows continue past the restored tail (batch_idx restarts at 1)
    plot_data = cont_plot_data
    plot_base = int(plot_data[-1][0]) if plot_data else 0
    batch_idx = 1
    try:
        while True:
            if 0 <= cfg.nbBatches < batch_idx:
                print("<trainer> Last batch reached.")
                if last_saved != ts.step:
                    save()
                break
            end = next_boundary(batch_idx)
            seg_losses = segment(ts, noise_gen, end - batch_idx + 1)
            losses.extend(seg_losses.cpu().tolist())
            for i in range(batch_idx, end + 1):
                timer.tick(i)
            batch_idx = end

            if batch_idx % 100 == 0:
                tail = losses[-100:]
                lo, avg, hi = min(tail), float(np.mean(tail)), max(tail)
                print(f"<trainer> batch {batch_idx} loss "
                      f"low/avg/high: {lo:.4f}/{avg:.4f}/{hi:.4f}")
                if not multi:
                    # noise-vs-recovered printout of the first 10
                    # components (train_r.lua:178-183)
                    z_ex = noise_inputs(preview_gen, 2, cfg.noiseDim,
                                        cfg.noiseMethod, device=device)
                    _, z_hat, _ = roundtrip(z_ex)
                    print("Example:")
                    print(f"Noise for G: {_fmt10(z_ex[0])}")
                    print(f"Result by R: {_fmt10(z_hat[0])}")
                writer.scalar("r_loss_low", lo, step=batch_idx)
                writer.scalar("r_loss_avg", avg, step=batch_idx)
                writer.scalar("r_loss_high", hi, step=batch_idx)
                plot_data.append([plot_base + batch_idx, lo, avg, hi])
                if not cfg.noplot:
                    # the reference's 'R Loss' window (train_r.lua:204; its
                    # x label says 'epoch' but the value is the batch)
                    writer.chart("plot_r_loss", plot_data,
                                 ["batch", "R loss (low)", "R loss (avg)",
                                  "R loss (high)"],
                                 title="R Loss", subdir="images_r")
            if batch_idx % 25 == 0 and not cfg.noplot and not multi:
                # G -> R -> G round-trip preview grid (train_r.lua:207-218)
                z = noise_inputs(preview_gen, 16, cfg.noiseDim,
                                 cfg.noiseMethod, device=device)
                imgs, _, fixed = roundtrip(z)
                both = np.concatenate(
                    [common.to_nhwc_rgb(imgs, cfg.colorSpace),
                     common.to_nhwc_rgb(fixed, cfg.colorSpace)])
                writer.image_grid("g_r_g", both, 4, 8, batch_idx,
                                  subdir="images_r")
            if batch_idx % cfg.saveFreq == 0 or guard.should_stop:
                save()
            if guard.should_stop:
                break
            batch_idx += 1
    finally:
        guard.restore()
        writer.close()
    return {"ts": ts, "losses": losses, "checkpoint": ckpt_path}


if __name__ == "__main__":
    main()
