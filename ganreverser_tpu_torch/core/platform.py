"""The device an entry point runs on, as the JAX CLIs honour
GANREVERSER_PLATFORM."""
from __future__ import annotations

import os

import torch


def resolve_device() -> torch.device:
    """The device named by GANREVERSER_PLATFORM: ``cpu`` is the CPU; unset,
    ``gpu`` or ``cuda`` is the current CUDA device, and raises when CUDA is
    absent — a run meant for the card never carries on on the CPU."""
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
