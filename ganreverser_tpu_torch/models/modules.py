"""``nn.Module``s of the layers G3, R and D2 use — the counterparts of
ganreverser_tpu/models/modules.py, in evaluation and in training.

Conventions kept from the JAX package, so that its checkpoints map onto
these modules name for name (``models/bridge.py``):

* activations are NHWC; conv weights are HWIO (``kernel``), dense weights
  (in, out) (``kernel``); BatchNorm has ``scale``/``bias`` parameters and
  ``mean``/``var`` running statistics (buffers), eps 1e-5;
* ``Sequential`` names its children ``l0``, ``l1``, ... after the layer
  indices of the checkpoint tree, ``ConcatBranches`` its branches ``b0``,
  ``b1``, ...;
* parameters stay f32; a layer computes in its ``dtype``: operands are
  rounded to it, products accumulate in f32, and the output is rounded to
  it again.

In training mode (``.train()``) BatchNorm normalises with the batch
statistics and updates its running buffers, and the dropouts drop; the
fixer-R's always-on input dropout is active in evaluation too, as in the
reference. Every active dropout draws from the ``generator`` its caller set
(:func:`set_dropout_generator`); there is no hidden global stream. The
plain convolutions here go through ``F.conv2d`` on NCHW views.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import pinned_precision
from ..ops.dropout_kernel import draw_seed, fused_dropout
from ..ops.upsample_conv import conv_nhwc, upsample2_conv3x3_dilated

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


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
    """nn.SpatialConvolution k x k (odd k, 3 by default), stride 1, padding
    (k - 1) / 2; ``kernel`` is HWIO."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32, kernel: int = 3):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel, kernel, in_ch,
                                               features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator):
        k, _, ci, _ = self.kernel.shape
        _heuristic_(self.kernel, k * k * ci, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        y = conv_nhwc(x, self.kernel, (self.kernel.shape[0] - 1) // 2,
                      self.dtype)
        return (y + self.bias).to(self.dtype)


class UpsampleConv(Conv):
    """Fused nearest-upsample(2x) + 3x3 SAME conv, one conv over the
    zero-inserted input (ops/upsample_conv.py), with the parameters of
    Conv."""

    def forward(self, x):
        return upsample2_conv3x3_dilated(x, self.kernel, self.bias, self.dtype)


class BatchNorm(nn.Module):
    """nn.(Spatial)BatchNormalization over the last axis, statistics in f32.

    In evaluation it normalises with the running statistics. In training it
    normalises with the batch mean and biased variance over all other axes
    (gradients flow through them) and moves the running buffers by momentum
    0.1 towards the batch mean and the unbiased variance, as torch does."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        if self.training:
            red = tuple(range(x.ndim - 1))
            mean = xf.mean(dim=red)
            var = xf.var(dim=red, correction=0)
            count = x.numel() // x.shape[-1]
            with torch.no_grad():
                m = _BN_MOMENTUM
                unbiased = var * (count / max(count - 1, 1))
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + _BN_EPS) * self.scale
        return ((xf - mean) * inv + self.bias).to(self.dtype)


class PReLU(nn.Module):
    """nn.PReLU(): one shared learnable slope ``alpha`` of shape (1,),
    initialised to 0.25; ``where(x >= 0, x, a x)`` with ``a`` cast to the
    input's dtype."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


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
    """nn.Dropout: active in training, the identity in evaluation.

    ``always_on=True`` is the fixer-R's input dropout, which the reference
    keeps active at inference (models.lua:399-406). An active call draws
    from ``self.generator``, which the caller sets: with ``impl="plain"`` a
    Bernoulli keep mask (the JAX default threefry path; the stream differs
    from JAX's), with ``impl="kernel"`` one int32 seed for kernel B5
    (ops/dropout_kernel.py), whose mask is the JAX kernel's for that
    seed."""

    def __init__(self, rate: float = 0.5, always_on: bool = False,
                 impl: str = "plain"):
        super().__init__()
        if impl not in ("plain", "kernel"):
            raise ValueError(f"dropout impl {impl!r}: expected plain or kernel")
        self.rate = rate
        self.always_on = always_on
        self.impl = impl
        self.generator: torch.Generator | None = None

    def _active_generator(self) -> torch.Generator | None:
        """The generator of an active call, None when the call is the
        identity; raises when it is active without one."""
        if self.rate == 0.0 or not (self.training or self.always_on):
            return None
        if self.generator is None:
            raise ValueError(f"an active {type(self).__name__} needs "
                             ".generator set (set_dropout_generator)")
        return self.generator

    def forward(self, x):
        gen = self._active_generator()
        if gen is None:
            return x
        if self.impl == "kernel":
            return fused_dropout(x, draw_seed(gen, x.device), self.rate)
        keep = dropout_keep_mask(x.shape, self.rate, gen, x.device)
        return apply_dropout(x, keep, self.rate)


class SpatialDropout(Dropout):
    """nn.SpatialDropout: in training, one Bernoulli mask per (sample,
    channel) drops whole feature maps; the identity in evaluation."""

    def __init__(self, rate: float = 0.25):
        super().__init__(rate)

    def forward(self, x):
        gen = self._active_generator()
        if gen is None:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        keep = dropout_keep_mask(shape, self.rate, gen, x.device)
        return apply_dropout(x, keep, self.rate)


def set_dropout_generator(module: nn.Module,
                          generator: torch.Generator) -> nn.Module:
    """Make every Dropout and SpatialDropout of ``module`` draw from
    ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    return module


class MaxPool(nn.Module):
    """nn.SpatialMaxPooling(2, 2) on NHWC."""

    def forward(self, x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class AvgPool(nn.Module):
    """nn.SpatialAveragePooling(2, 2, 2, 2) on NHWC: the mean of each
    window in f32, rounded back to the input's dtype."""

    def forward(self, x):
        y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), 2)
        return y.permute(0, 2, 3, 1).to(x.dtype)


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


class ConcatBranches(nn.Module):
    """nn.Concat over features: every branch runs on the same input and the
    outputs are concatenated on the last (channel) axis. The branches are
    named b0, b1, ... (create_D2's left/right split, models.lua:293-321)."""

    def __init__(self, branches: Sequence[nn.Module]):
        super().__init__()
        for i, b in enumerate(branches):
            self.add_module(f"b{i}", b)

    def forward(self, x):
        return torch.cat([b(x) for b in self.children()], dim=-1)


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every Dense/Conv weight of ``module`` with the 'heuristic'
    scheme and zero biases, in module order, from ``generator``."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            m.reset_parameters(generator)
    return module
