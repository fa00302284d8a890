"""Gradient and loss transforms of ganreverser_tpu/optim/transforms.py:
clamp, L1 and L2 (adversarial.lua:8-28), applied in the reference's order
L1 -> L2 -> clamp. ``params`` and ``grads`` are aligned lists; every
parameter takes part, BatchNorm scales and biases included, and the
returned loss carries the penalty terms."""
from __future__ import annotations

import torch


@torch.no_grad()
def clamp_grads(grads: list, clamp_value: float) -> list:
    """Elementwise clip to [-clamp_value, clamp_value], in place; 0
    disables."""
    if clamp_value == 0:
        return grads
    torch._foreach_clamp_min_(grads, -clamp_value)
    torch._foreach_clamp_max_(grads, clamp_value)
    return grads


@torch.no_grad()
def l1_penalty(params: list, grads: list, loss, l1_weight: float):
    """loss += w ||p||_1; grad += w sign(p)."""
    if l1_weight == 0:
        return grads, loss
    norm = torch.stack(torch._foreach_norm(params, 1)).sum()
    grads = torch._foreach_add(
        grads, torch._foreach_mul(torch._foreach_sign(params), l1_weight))
    return grads, loss + l1_weight * norm


@torch.no_grad()
def l2_penalty(params: list, grads: list, loss, l2_weight: float):
    """loss += w ||p||_2^2 / 2; grad += w p."""
    if l2_weight == 0:
        return grads, loss
    sq = torch.stack(torch._foreach_norm(params, 2)).square().sum()
    grads = torch._foreach_add(grads, torch._foreach_mul(params, l2_weight))
    return grads, loss + l2_weight * sq / 2.0


def regularize(params: list, grads: list, loss, l1_weight: float,
               l2_weight: float, clamp_value: float):
    """The reference pipeline: L1 -> L2 -> clamp; returns (grads, loss)."""
    grads, loss = l1_penalty(params, grads, loss, l1_weight)
    grads, loss = l2_penalty(params, grads, loss, l2_weight)
    return clamp_grads(grads, clamp_value), loss
