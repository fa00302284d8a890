"""Shared CLI glue: device selection and compute dtype."""
from __future__ import annotations

import os

import torch


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
