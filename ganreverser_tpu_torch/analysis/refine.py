"""Gradient-based latent refinement, the counterpart of
ganreverser_tpu/analysis/refine.py.

Given target images and a first guess z0 (R's output), adam on z through the
frozen module G minimises each image's pixel MSE. G's fast path has no
backward (kernel U has none, in JAX neither), so the refiner runs the module
G (models/zoo.py) with torch autograd.

The loss is a sum of per-image terms and adam is elementwise, so refining
each chunk of ``batch_size`` rows on its own gives what refining all N at
once gives; the chunks keep the backward's activations to one chunk's
(a whole-N backward at 10,000 x 64x64 would need tens of GB).

adam is written out as the JAX package writes it (``refine.py:43-47``), with
the bias correction folded into the step size,
``z -= lr sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)``, which places
eps differently from ``torch.optim.Adam``.

A chunk is the span ``gr.refine.chunk`` (io/metrics.py::span), holding at
each adam step ``gr.refine.forward``, ``gr.refine.backward`` and
``gr.refine.adam``, then ``gr.refine.loss``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core.precision import pinned_precision
from ..io.metrics import span


def make_refiner(G: nn.Module, *, steps: int = 100, lr: float = 0.05,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 dtype: torch.dtype = torch.float32,
                 batch_size: int | None = None):
    """Returns ``refine(images, z0) -> (z, final_loss)``, both f32, where
    final_loss is the per-image pixel MSE at the last z. ``G`` is the port's
    module G in evaluation with its weights loaded; it is frozen here
    (``requires_grad_(False)``). ``dtype`` is G's compute dtype, which pins
    the precision of the forward and the backward (core/precision.py);
    ``batch_size`` (default: all rows) is the chunk size."""
    G.requires_grad_(False)

    def per_image_loss(z, target):
        d = G(z).float() - target
        return (d * d).mean(dim=tuple(range(1, d.ndim)))

    def refine_chunk(images, z0):
        with span("gr.refine.chunk"):
            target = images.float().clone()
            z = z0.detach().float().clone()
            m = torch.zeros_like(z)
            v = torch.zeros_like(z)
            for t in range(1, steps + 1):
                z.requires_grad_(True)
                with torch.enable_grad(), pinned_precision(dtype):
                    with span("gr.refine.forward"):
                        loss = per_image_loss(z, target).sum()
                    with span("gr.refine.backward"):
                        (g,) = torch.autograd.grad(loss, z)
                with span("gr.refine.adam"):
                    z = z.detach()
                    m = b1 * m + (1 - b1) * g
                    v = b2 * v + (1 - b2) * g * g
                    step_size = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
                    z = z - step_size * m / (torch.sqrt(v) + eps)
            with span("gr.refine.loss"), torch.no_grad(), \
                    pinned_precision(dtype):
                return z, per_image_loss(z, target)

    def refine(images: torch.Tensor, z0: torch.Tensor):
        n = images.shape[0]
        bs = batch_size or n
        parts = [refine_chunk(images[s:s + bs], z0[s:s + bs])
                 for s in range(0, n, bs)]
        return (torch.cat([z for z, _ in parts]),
                torch.cat([loss for _, loss in parts]))

    return refine
