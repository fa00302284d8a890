"""Eval-mode BatchNorm folding (the host helper of
ganreverser_tpu/ops/conv_kernel.py). The single-layer conv3x3_bn_act kernel
of that module is not ported yet (ROADMAP.md, queue B)."""
from __future__ import annotations

import torch


def fold_batchnorm(bn_params: dict, bn_state: dict, conv_bias: torch.Tensor,
                   eps: float = 1e-5):
    """Fold conv bias + eval-mode BN into per-channel f32 (scale, shift):
    y = (conv + bias - mean) * g / sqrt(var + eps) + b."""
    g = bn_params["scale"].float()
    b = bn_params["bias"].float()
    mean = bn_state["mean"].float()
    var = bn_state["var"].float()
    scale = g * torch.rsqrt(var + eps)
    shift = (conv_bias.float() - mean) * scale + b
    return scale, shift
