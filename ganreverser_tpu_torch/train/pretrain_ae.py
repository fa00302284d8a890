"""Autoencoder warm start for G — the counterpart of
ganreverser_tpu/train/pretrain_ae.py (pretrain_g.lua).

G_encoder then G (the decoder) trained as an autoencoder with MSE
reconstruction on real images (pretrain_g.lua:85-89, 148-180). Only the
decoder is saved, as ``g_pretrained_<C>x<H>x<W>_nd<z>`` (pretrain_g.lua:
191-202 saves ``:get(2)``), which ``train`` loads when present.

The step is eager: forward and backward under ``pinned_precision(dtype)``,
then L1 -> L2 -> clamp and the optimizer, in place; nothing waits for the
host.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..core.precision import pinned_precision
from ..models.bridge import export_variables
from ..models.modules import Sequential
from ..optim import Optimizer, adam, regularize
from .losses import mse
from .state import TrainState


def make_autoencoder(G_encoder: nn.Module, G_decoder: nn.Module) -> nn.Module:
    """nn.Sequential(G_ENCODER, G_DECODER) (pretrain_g.lua:85-89): the
    encoder is child ``l0``, the decoder ``l1``, the keys of the JAX
    container's variables."""
    return Sequential([G_encoder, G_decoder])


def decoder_variables(autoencoder: nn.Module) -> dict:
    """The decoder's ``{"params", "state"}`` tree (``:get(2)``), the
    g_pretrained checkpoint's content, loadable by the JAX G."""
    return export_variables(autoencoder.l1)


def make_ae_train_step(*, dtype: torch.dtype, g_l1: float = 0.0,
                       g_l2: float = 0.0, g_clamp: float = 5.0,
                       opt: Optional[Optimizer] = None) -> Callable:
    """Returns ``step(ts, images) -> loss``: one update of ``ts.module``
    (the autoencoder, in training mode) on MSE(AE(images), images), in
    place. ``loss`` is the f32 0-d device tensor with the penalties."""
    opt = opt or adam()

    def step(ts: TrainState, images: torch.Tensor) -> torch.Tensor:
        AE = ts.module.train()
        params = list(AE.parameters())
        with pinned_precision(dtype):
            loss = mse(AE(images), images)
            grads = torch.autograd.grad(loss, params)
        grads, loss = regularize(params, list(grads), loss.detach(), g_l1,
                                 g_l2, g_clamp)
        opt.update(grads, ts.opt_state, params)
        ts.step += 1
        return loss

    return step
