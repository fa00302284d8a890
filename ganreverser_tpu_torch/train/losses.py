"""Loss criteria of ganreverser_tpu/train/losses.py — nn.BCECriterion and
nn.MSECriterion, size-averaged like torch, computed in f32."""
from __future__ import annotations

import torch

_EPS = 1e-7  # probabilities are clamped, as the JAX package clamps them


def bce(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities, mean over all elements."""
    o = outputs.float().clamp(_EPS, 1.0 - _EPS)
    t = targets.float()
    return -torch.mean(t * torch.log(o) + (1.0 - t) * torch.log(1.0 - o))


def mse(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements."""
    d = outputs.float() - targets.float()
    return torch.mean(d * d)
