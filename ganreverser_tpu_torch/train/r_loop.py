"""Reverser training — the counterpart of ganreverser_tpu/train/r_loop.py.

R trains on synthetic pairs only: z ~ noise, images = G(z) with G frozen in
evaluation, loss = MSE(R(images), z) (train_r.lua:138-168), then the L1/L2
penalties and the gradient clamp (defaults L2 = 1e-4, clamp 1), then adam.

JAX compiles the step, and a segment of steps as one ``lax.scan``, into one
program. Here the step is eager: the forward and the backward run under
``pinned_precision(dtype)``, so an f32 step computes its convolutions and
matrix products in IEEE f32 whatever the process-wide TF32 flags say (the
backward runs outside the layers' own pins), and nothing in a segment
waits for the host until its losses are read, once.

With a ``mesh`` (JAX's ``mesh=``, a batch sharded over 'data') each rank
trains on its rows of the batch: every rank draws the whole batch's
latents from its generator (the same stream on every rank) and keeps its
rows, R's BatchNorm and dropouts treat the rows as part of the whole batch
(models/modules.py::set_data_parallel, set by the caller), and the loss
and the gradients are averaged over the 'data' group before the penalties
and the update, so a step on R ranks gives the step of one rank on the
whole batch. A train state with 'model' shards gathers R's (and with
``g_shards`` G's) whole parameters for the step and updates its slices.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..core.precision import pinned_precision
from ..core.prng import noise_inputs
from ..models.modules import set_dropout_generator
from ..optim import Optimizer, adam, regularize
from ..parallel.comm import pmean
from ..parallel.mesh import Mesh, ModelShards, whole_params
from .losses import mse
from .state import TrainState


def make_r_train_step(G: nn.Module, *, dtype: torch.dtype,
                      r_l1: float = 0.0, r_l2: float = 1e-4,
                      r_clamp: float = 1.0,
                      opt: Optional[Optimizer] = None,
                      mesh: Optional[Mesh] = None,
                      g_shards: Optional[ModelShards] = None) -> Callable:
    """Returns ``step(ts, z) -> loss``: one update of ``ts.module`` (R, in
    training mode; its dropouts draw from the generator set on them) on the
    latents ``z`` (with ``mesh``: this rank's rows of the batch), in place.
    ``loss`` is the f32 0-d device tensor of the MSE plus the penalties,
    the whole batch's. ``G`` is frozen and runs in evaluation under
    ``no_grad``; ``dtype`` is the models' compute dtype."""
    opt = opt or adam()
    G.eval().requires_grad_(False)

    def step(ts: TrainState, z: torch.Tensor) -> torch.Tensor:
        R = ts.module.train()
        with whole_params(ts, g_shards):
            params = list(R.parameters())
            with pinned_precision(dtype):
                with torch.no_grad():
                    images = G(z)
                loss = mse(R(images), z)
                grads = list(torch.autograd.grad(loss, params))
            loss = loss.detach()
            if mesh is not None:
                grads, loss = pmean((grads, loss), mesh)
            grads, loss = regularize(params, grads, loss, r_l1, r_l2,
                                     r_clamp)
            grads, tensors = ts.update_targets(grads)
            opt.update(grads, ts.opt_state, tensors)
        ts.step += 1
        return loss

    return step


def make_r_segment_program(G: nn.Module, *, batch_size: int, noise_dim: int,
                           noise_method: str, dtype: torch.dtype,
                           mesh: Optional[Mesh] = None,
                           **penalties) -> Callable:
    """Returns ``segment(ts, generator, n_batches) -> losses``: that many
    train steps, each on a fresh batch of latents drawn from ``generator``
    (on its device; with ``mesh`` every rank draws the whole batch and
    trains on its rows). ``losses`` (n_batches,) stays on the device: one
    host fetch per segment, the counterpart of the JAX segment's single
    ``lax.scan`` dispatch (train_r's low/avg/high records come from it).
    ``penalties`` go to :func:`make_r_train_step`."""
    step = make_r_train_step(G, dtype=dtype, mesh=mesh, **penalties)
    rows = mesh.rows(batch_size) if mesh is not None else slice(None)

    def segment(ts: TrainState, generator: torch.Generator,
                n_batches: int) -> torch.Tensor:
        losses = []
        for _ in range(n_batches):
            z = noise_inputs(generator, batch_size, noise_dim, noise_method,
                             device=generator.device)
            losses.append(step(ts, z[rows]))
        return torch.stack(losses)

    return segment


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, inputs_fn: Callable,
                        n_batches: int = 50) -> nn.Module:
    """Settle the BatchNorm running statistics of ``model`` with
    training-mode forwards of ``inputs_fn(i)``, i < n_batches (a random G
    has mean 0 / var 1 statistics, so its evaluation output hardly depends
    on z until they are warmed). Returns the model in evaluation."""
    model.train()
    for i in range(n_batches):
        model(inputs_fn(i))
    return model.eval()


def make_r_eval_step(R: nn.Module, *, fixer: bool = False) -> Callable:
    """Returns ``invert(images[, generator]) -> z`` with R in evaluation
    under ``no_grad``. The fixer-R's always-on input dropout draws from
    ``generator``, which becomes the generator of R's dropouts; the plain
    R is deterministic and takes none."""

    def invert(images: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if fixer:
            if generator is None:
                raise ValueError("the fixer-R's evaluation needs a generator")
            set_dropout_generator(R, generator)
        R.eval()
        with torch.no_grad():
            return R(images)

    return invert
