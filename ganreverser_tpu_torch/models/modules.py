"""Eval-mode ``nn.Module``s of the layers G3 and R use — the counterparts of
ganreverser_tpu/models/modules.py.

Conventions kept from the JAX package, so that its checkpoints map onto
these modules name for name (``models/bridge.py``):

* activations are NHWC; conv weights are HWIO (``kernel``), dense weights
  (in, out) (``kernel``); BatchNorm has ``scale``/``bias`` parameters and
  ``mean``/``var`` running statistics (buffers), eps 1e-5;
* ``Sequential`` names its children ``l0``, ``l1``, ... after the layer
  indices of the checkpoint tree;
* parameters stay f32; a layer computes in its ``dtype``: operands are
  rounded to it, products accumulate in f32, and the output is rounded to
  it again.

Only evaluation is ported: a BatchNorm or a dropout in training mode raises;
the fixer-R's always-on input dropout is active in evaluation, as in the
reference. The plain convolutions here go through ``F.conv2d`` on NCHW
views.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import pinned_precision
from ..ops.upsample_conv import conv_nhwc, upsample2_conv3x3_dilated

_BN_EPS = 1e-5


def _heuristic_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """weight-init.lua's 'heuristic': uniform(+-sqrt(1 / (3 fan_in)))."""
    std = math.sqrt(1.0 / (3.0 * fan_in))
    with torch.no_grad():
        t.uniform_(-std, std, generator=generator)


def dense(x: torch.Tensor, kernel: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """x @ kernel with operands rounded to ``dtype``, f32 result, at the
    precision pinned for ``dtype`` (core/precision.py)."""
    with pinned_precision(dtype):
        return x.to(dtype).float() @ kernel.to(dtype).float()


def dropout_keep_mask(shape, rate: float, generator: torch.Generator,
                      device: torch.device | str) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask of ``shape`` (bool), drawn from
    ``generator`` on ``device`` (the generator's device)."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def apply_dropout(x: torch.Tensor, keep: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """Survivors scaled by 1 / (1 - rate), dropped elements zero, cast back
    to ``x.dtype`` (the JAX Dropout's ``where(mask, x / keep, 0)``)."""
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class Dense(nn.Module):
    """nn.Linear; ``kernel`` is (in, out)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator):
        _heuristic_(self.kernel, self.kernel.shape[0], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return (dense(x, self.kernel, self.dtype) + self.bias).to(self.dtype)


class Conv(nn.Module):
    """nn.SpatialConvolution 3x3, stride 1, SAME padding; ``kernel`` is
    HWIO."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, in_ch, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator):
        _heuristic_(self.kernel, 9 * self.kernel.shape[2], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        y = conv_nhwc(x, self.kernel, 1, self.dtype)
        return (y + self.bias).to(self.dtype)


class UpsampleConv(Conv):
    """Fused nearest-upsample(2x) + 3x3 SAME conv, one conv over the
    zero-inserted input (ops/upsample_conv.py), with the parameters of
    Conv."""

    def forward(self, x):
        return upsample2_conv3x3_dilated(x, self.kernel, self.bias, self.dtype)


class BatchNorm(nn.Module):
    """nn.(Spatial)BatchNormalization in evaluation: normalises the last
    axis with the running statistics."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNorm with batch statistics is not ported yet; call "
                ".eval()")
        inv = torch.rsqrt(self.var + _BN_EPS) * self.scale
        return ((x.float() - self.mean) * inv + self.bias).to(self.dtype)


class Activation(nn.Module):
    """relu / elu (alpha 1) / sigmoid / tanh."""

    _FNS = {"relu": F.relu, "elu": F.elu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh}

    def __init__(self, fn: str):
        super().__init__()
        self.fn = fn
        self._apply_fn = self._FNS[fn]

    def forward(self, x):
        return self._apply_fn(x)


class Dropout(nn.Module):
    """nn.Dropout: the identity in evaluation; training is not ported yet.

    ``always_on=True`` is the fixer-R's input dropout, which the reference
    keeps active at inference (models.lua:399-406): every call draws a
    fresh keep mask from ``self.generator``, which the caller sets (there
    is no hidden global stream)."""

    def __init__(self, rate: float = 0.5, always_on: bool = False):
        super().__init__()
        self.rate = rate
        self.always_on = always_on
        self.generator: torch.Generator | None = None

    def forward(self, x):
        if self.rate == 0.0:
            return x
        if self.always_on:
            if self.generator is None:
                raise ValueError("an always-on Dropout needs .generator set")
            keep = dropout_keep_mask(x.shape, self.rate, self.generator,
                                     x.device)
            return apply_dropout(x, keep, self.rate)
        if self.training:
            raise NotImplementedError("dropout in training is not ported yet")
        return x


class SpatialDropout(Dropout):
    """nn.SpatialDropout (whole channels in training): the identity in
    evaluation."""


class MaxPool(nn.Module):
    """nn.SpatialMaxPooling(2, 2) on NHWC."""

    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class Flatten(nn.Module):
    """nn.View(n): collapse to (batch, -1) in (H, W, C) order."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Reshape(nn.Module):
    """nn.View/nn.Reshape to a fixed non-batch shape (NHWC order)."""

    def __init__(self, shape: Sequence[int]):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.shape)


class Identity(nn.Module):
    def forward(self, x):
        return x


class Sequential(nn.Sequential):
    """nn.Sequential whose children are named l0, l1, ... — the layer keys
    of the checkpoint tree."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__(OrderedDict((f"l{i}", m) for i, m in enumerate(layers)))


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every Dense/Conv weight of ``module`` with the 'heuristic'
    scheme and zero biases, in module order, from ``generator``."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            m.reset_parameters(generator)
    return module
