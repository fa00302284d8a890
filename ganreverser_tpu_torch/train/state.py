"""The train state of one network and of the G/D pair — the counterparts
of ganreverser_tpu/train/state.py's ``TrainState`` and ``GanState``.

JAX threads params, module state and optimizer state through pure
functions and merges the BatchNorm statistics a step reports back
(``merge_state``). Here the module owns its parameters and BatchNorm
buffers and a step updates both in place, so there is nothing to merge.

On a mesh with a 'model' axis (JAX's ``shard_params`` of the params and
the optimizer state, cli/common.py::place_gan_on_mesh) a train state keeps
only this rank's slices (:meth:`TrainState.shard_model_axis`): the
parameters in ``shards`` (parallel/mesh.py::ModelShards), the moments
sliced alike; a step gathers the whole parameters for its forward and
backward and updates the slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from torch import nn

from ..optim import Optimizer
from ..parallel.mesh import Mesh, ModelShards


@dataclass
class TrainState:
    """A module (parameters and BatchNorm buffers), its optimizer state
    (``Optimizer.init``'s dict, lists aligned with ``module.parameters()``)
    and the number of steps taken; ``shards`` holds the parameters' slices
    on a 'model' axis (None: the module holds them whole)."""
    module: nn.Module
    opt_state: dict
    step: int = 0
    shards: Optional[ModelShards] = None

    @classmethod
    def create(cls, module: nn.Module, opt: Optimizer) -> "TrainState":
        return cls(module=module, opt_state=opt.init(list(module.parameters())))

    def shard_model_axis(self, mesh: Mesh,
                         min_size: int = 1 << 16) -> "TrainState":
        """Keep only this rank's 'model' slices of the parameters and of
        the optimizer's per-parameter state; returns self."""
        self.shards = ModelShards(self.module, mesh, min_size)
        self.opt_state = {k: self.shards.slice(v) if isinstance(v, list)
                          else v for k, v in self.opt_state.items()}
        return self

    def update_targets(self, grads: list) -> tuple:
        """(grads, tensors) an optimizer update takes: the whole gradients
        and the parameters, or with shards this rank's slices of both."""
        if self.shards is None:
            return grads, list(self.module.parameters())
        return self.shards.slice(grads), self.shards.local

    def whole_opt_state(self) -> dict:
        """The optimizer state with whole per-parameter leaves (a
        collective over the 'model' group when sharded)."""
        if self.shards is None:
            return self.opt_state
        return {k: self.shards.gather(v) if isinstance(v, list) else v
                for k, v in self.opt_state.items()}


@dataclass
class GanState:
    """G and D of adversarial training, each with its optimizer state
    (train.lua's MODEL_G/MODEL_D and OPTSTATE)."""
    g: TrainState
    d: TrainState
