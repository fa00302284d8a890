"""Shared CLI glue: device selection, compute dtype, train state <->
checkpoint tree, host images for artifacts."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..data.colorspace import to_rgb
from ..models import bridge
from ..optim import Optimizer
from ..train.state import TrainState


def resolve_device() -> torch.device:
    """The device named by GANREVERSER_PLATFORM, as the JAX CLIs honour it:
    ``cpu`` is the CPU; unset, ``gpu`` or ``cuda`` is the current CUDA
    device, and raises when CUDA is absent — a run meant for the card never
    carries on on the CPU."""
    plat = os.environ.get("GANREVERSER_PLATFORM", "gpu").lower()
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("gpu", "cuda"):
        raise ValueError(f"GANREVERSER_PLATFORM={plat!r}: expected cpu or gpu")
    if not torch.cuda.is_available():
        raise RuntimeError("GANREVERSER_PLATFORM asks for the GPU, but CUDA "
                           "is not available (set GANREVERSER_PLATFORM=cpu "
                           "to run on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def compute_dtype(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        getattr(cfg, "compute_dtype", "float32")]


def ts_to_tree(ts: TrainState) -> dict:
    """The JAX package's train-state tree (its cli/common.py::ts_to_tree):
    ``{"params", "state", "opt_state", "step"}``, the optimizer's
    per-parameter lists nested like the params, the step counts int32."""
    names = [n for n, _ in ts.module.named_parameters()]
    variables = bridge.export_variables(ts.module)
    opt_state = {k: (bridge.nest_by_name(dict(zip(names, v)))
                     if isinstance(v, list) else bridge.leaf_array(v))
                 for k, v in ts.opt_state.items()}
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


def to_nhwc_rgb(images: torch.Tensor, colorspace: str) -> np.ndarray:
    """Device NHWC images (any colour space) as host RGB f32."""
    return to_rgb(images.float().cpu().numpy(), colorspace)
