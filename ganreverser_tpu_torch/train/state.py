"""The train state of one network and of the G/D pair — the counterparts
of ganreverser_tpu/train/state.py's ``TrainState`` and ``GanState``.

JAX threads params, module state and optimizer state through pure
functions and merges the BatchNorm statistics a step reports back
(``merge_state``). Here the module owns its parameters and BatchNorm
buffers and a step updates both in place, so there is nothing to merge.
"""
from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from ..optim import Optimizer


@dataclass
class TrainState:
    """A module (parameters and BatchNorm buffers), its optimizer state
    (``Optimizer.init``'s dict, lists aligned with ``module.parameters()``)
    and the number of steps taken."""
    module: nn.Module
    opt_state: dict
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, opt: Optimizer) -> "TrainState":
        return cls(module=module, opt_state=opt.init(list(module.parameters())))


@dataclass
class GanState:
    """G and D of adversarial training, each with its optimizer state
    (train.lua's MODEL_G/MODEL_D and OPTSTATE)."""
    g: TrainState
    d: TrainState
