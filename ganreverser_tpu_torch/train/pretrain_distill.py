"""Net2net distillation warm start — the counterpart of
ganreverser_tpu/train/pretrain_distill.py (pretrain_with_previous_net.lua).

A new G and D of another size, noise dimension or colour space learn from
a previous pair:

* the new G mimics G_prev's images with MSE, the new latents' leading
  min(new_nd, prev_nd) components copied from G_prev's latents
  (pretrain_with_previous_net.lua:150-159, 185-211);
* the new D mimics D_prev's soft predictions with BCE on half-real,
  half-G_prev batches (161-183, 213-242).

The steps take their latents and targets from the caller, so tests can hand
both packages the same numbers; each runs its forward and backward under
one ``pinned_precision(dtype)``, then L1 -> L2 -> clamp and adam, in
place.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.precision import pinned_precision
from ..core.prng import noise_inputs
from ..optim import Optimizer, adam, regularize
from .losses import bce, mse
from .state import TrainState


def paired_noise(generator: torch.Generator, n: int, new_nd: int,
                 new_method: str, prev_nd: int, prev_method: str,
                 device: torch.device | str = "cpu"):
    """(prev_z, new_z), drawn in that order from ``generator`` on
    ``device``, with new_z's leading min(new_nd, prev_nd) components copied
    from prev_z (pretrain_with_previous_net.lua:150-159)."""
    prev_z = noise_inputs(generator, n, prev_nd, prev_method, device=device)
    new_z = noise_inputs(generator, n, new_nd, new_method, device=device)
    shared = min(new_nd, prev_nd)
    new_z[:, :shared] = prev_z[:, :shared]
    return prev_z, new_z


def make_distill_g_step(*, dtype: torch.dtype, g_l1: float = 0.0,
                        g_l2: float = 0.0, g_clamp: float = 5.0,
                        opt: Optional[Optimizer] = None) -> Callable:
    """Returns ``step(ts, new_z, targets) -> loss``: MSE(G(new_z),
    targets) with G = ``ts.module`` in training mode, where ``targets`` are
    G_prev's images converted to the new colour space and geometry."""
    opt = opt or adam()

    def step(ts: TrainState, z: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        G = ts.module.train()
        params = list(G.parameters())
        with pinned_precision(dtype):
            loss = mse(G(z), targets)
            grads = torch.autograd.grad(loss, params)
        grads, loss = regularize(params, list(grads), loss.detach(), g_l1,
                                 g_l2, g_clamp)
        opt.update(grads, ts.opt_state, params)
        ts.step += 1
        return loss

    return step


def make_distill_d_step(*, dtype: torch.dtype, d_l1: float = 0.0,
                        d_l2: float = 1e-4, d_clamp: float = 1.0,
                        opt: Optional[Optimizer] = None) -> Callable:
    """Returns ``step(ts, images, soft_targets) -> loss``: BCE(D(images),
    D_prev's predictions) with D = ``ts.module`` in training mode (its
    dropouts draw from the generator set on it)."""
    opt = opt or adam()

    def step(ts: TrainState, images: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        D = ts.module.train()
        params = list(D.parameters())
        with pinned_precision(dtype):
            loss = bce(D(images).reshape(-1), targets.reshape(-1))
            grads = torch.autograd.grad(loss, params)
        grads, loss = regularize(params, list(grads), loss.detach(), d_l1,
                                 d_l2, d_clamp)
        opt.update(grads, ts.opt_state, params)
        ts.step += 1
        return loss

    return step
