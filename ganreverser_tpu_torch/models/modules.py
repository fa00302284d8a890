"""``nn.Module``s of the zoo's layers (G3, G4, G_encoder, D2, D_default,
D_facegen, R, createResidual) — the counterparts of
ganreverser_tpu/models/modules.py, in evaluation and in training — and of
StyleGAN2's generator (:class:`StyleGenerator`, which has no counterpart
in the JAX package).

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

Dense and Conv carry their init scheme (``init_scheme``,
``init_zero_bias``) and BatchNorm its ``scale_init``, as the JAX layers
do; :func:`init_parameters` draws every layer by its own (models/init.py).

Under data parallelism (:func:`set_data_parallel`) a rank holds its rows
of a batch cut over the mesh's 'data' axis, and a training forward gives
what one rank gives on the whole batch, as GSPMD does for JAX's sharded
batch: BatchNorm takes its statistics over the whole batch (sums
all-reduced over the 'data' group, differentiably) and every dropout draws
the whole batch's mask and keeps this rank's rows (kernel B5: the counter
of its first element).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from functools import partial
from typing import Sequence

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import pinned_precision
from ..io.metrics import span
from ..ops.dropout_kernel import draw_seed, fused_dropout
from ..ops.fir_kernel import fir_filter
from ..ops.upsample_conv import (conv_nhwc, conv_transpose2_nhwc,
                                 upsample2_conv3x3_dilated)
from ..parallel.comm import psum
from .init import SCHEMES, init_bn_scale, init_conv, init_dense

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


def _check_scheme(scheme: str) -> str:
    if scheme not in SCHEMES:
        raise ValueError(f"Unknown init scheme {scheme!r}: expected one of "
                         f"{SCHEMES}")
    return scheme


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
                 dtype: torch.dtype = torch.float32,
                 init_scheme: str = "heuristic", init_zero_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.init_scheme = _check_scheme(init_scheme)
        self.init_zero_bias = init_zero_bias

    def reset_parameters(self, generator: torch.Generator):
        init_dense(self.kernel, self.bias, generator, self.init_scheme,
                   self.init_zero_bias)

    def forward(self, x):
        return (dense(x, self.kernel, self.dtype) + self.bias).to(self.dtype)


class Conv(nn.Module):
    """nn.SpatialConvolution k x k (odd k, 3 by default), stride 1, padding
    (k - 1) / 2; ``kernel`` is HWIO."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32, kernel: int = 3,
                 init_scheme: str = "heuristic", init_zero_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel, kernel, in_ch,
                                               features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.init_scheme = _check_scheme(init_scheme)
        self.init_zero_bias = init_zero_bias

    def reset_parameters(self, generator: torch.Generator):
        init_conv(self.kernel, self.bias, generator, self.init_scheme,
                  self.init_zero_bias)

    def forward(self, x):
        y = conv_nhwc(x, self.kernel, (self.kernel.shape[0] - 1) // 2,
                      self.dtype)
        return (y + self.bias).to(self.dtype)


class UpsampleConv(Conv):
    """Fused nearest-upsample(2x) + 3x3 SAME conv, one stride-2 transposed
    conv with the parity-aggregated 4x4 kernel (ops/upsample_conv.py), with
    the parameters of Conv."""

    def forward(self, x):
        return upsample2_conv3x3_dilated(x, self.kernel, self.bias, self.dtype)


class BatchNorm(nn.Module):
    """nn.(Spatial)BatchNormalization over the last axis, statistics in f32.

    In evaluation it normalises with the running statistics. In training it
    normalises with the batch mean and biased variance over all other axes
    (gradients flow through them) and moves the running buffers by momentum
    0.1 towards the batch mean and the unbiased variance, as torch does.
    With ``data_mesh`` set the batch is the whole one cut over the mesh's
    'data' axis: the sums behind the mean and the variance are all-reduced
    over the 'data' group. ``scale_init="torch"`` draws the scale from
    uniform(0, 1)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 scale_init: str = "ones"):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype
        self.scale_init = scale_init
        self.data_mesh = None

    def reset_parameters(self, generator: torch.Generator):
        init_bn_scale(self.scale, generator, self.scale_init)
        nn.init.zeros_(self.bias)

    def _global_stats(self, xf: torch.Tensor, red: tuple):
        """(mean, biased variance, count) over the whole batch cut over
        ``data_mesh``'s 'data' axis: two all-reductions, of the sums, then
        of the squared deviations from the mean."""
        count = xf.numel() // xf.shape[-1] * self.data_mesh.shape["data"]
        mean = psum(xf.sum(dim=red), self.data_mesh) / count
        d = xf - mean
        var = psum((d * d).sum(dim=red), self.data_mesh) / count
        return mean, var, count

    def forward(self, x):
        xf = x.float()
        if self.training:
            red = tuple(range(x.ndim - 1))
            if self.data_mesh is not None:
                mean, var, count = self._global_stats(xf, red)
            else:
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
    """relu / elu (alpha 1) / sigmoid / tanh / leaky_relu (slope 0.333,
    createResidual's nn.LeakyReLU(0.333))."""

    _FNS = {"relu": F.relu, "elu": F.elu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh,
            "leaky_relu": partial(F.leaky_relu, negative_slope=0.333)}

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
    seed. With ``data_mesh`` set the input is this rank's rows of a batch
    cut over the mesh's 'data' axis, and the mask is those rows of the
    whole batch's mask."""

    def __init__(self, rate: float = 0.5, always_on: bool = False,
                 impl: str = "plain"):
        super().__init__()
        if impl not in ("plain", "kernel"):
            raise ValueError(f"dropout impl {impl!r}: expected plain or kernel")
        self.rate = rate
        self.always_on = always_on
        self.impl = impl
        self.generator: torch.Generator | None = None
        self.data_mesh = None

    def _active_generator(self) -> torch.Generator | None:
        """The generator of an active call, None when the call is the
        identity; raises when it is active without one."""
        if self.rate == 0.0 or not (self.training or self.always_on):
            return None
        if self.generator is None:
            raise ValueError(f"an active {type(self).__name__} needs "
                             ".generator set (set_dropout_generator)")
        return self.generator

    def _rows(self, n: int) -> slice:
        """This rank's rows of the whole batch whose part has ``n`` rows
        (all of them without ``data_mesh``)."""
        if self.data_mesh is None:
            return slice(0, n)
        return self.data_mesh.rows(n * self.data_mesh.shape["data"])

    def _keep_mask(self, shape: tuple, gen: torch.Generator,
                   device) -> torch.Tensor:
        """The keep mask of this rank's rows: the whole batch's mask is
        drawn and cut."""
        if self.data_mesh is None:
            return dropout_keep_mask(shape, self.rate, gen, device)
        whole = (shape[0] * self.data_mesh.shape["data"],) + tuple(shape[1:])
        return dropout_keep_mask(whole, self.rate, gen,
                                 device)[self._rows(shape[0])]

    def forward(self, x):
        gen = self._active_generator()
        if gen is None:
            return x
        if self.impl == "kernel":
            base = self._rows(x.shape[0]).start * math.prod(x.shape[1:])
            return fused_dropout(x, draw_seed(gen, x.device), self.rate,
                                 base=base)
        keep = self._keep_mask(x.shape, gen, x.device)
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
        keep = self._keep_mask(shape, gen, x.device)
        return apply_dropout(x, keep, self.rate)


def set_dropout_generator(module: nn.Module,
                          generator: torch.Generator) -> nn.Module:
    """Make every Dropout and SpatialDropout of ``module`` draw from
    ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    return module


def set_data_parallel(module: nn.Module, mesh) -> nn.Module:
    """Make every BatchNorm and dropout of ``module`` treat its input as
    this rank's rows of a batch cut over ``mesh``'s 'data' axis (None:
    the input is the whole batch). Each rank's generators must be in the
    same state."""
    for m in module.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.data_mesh = mesh
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


class UpsampleNearest(nn.Module):
    """nn.SpatialUpSamplingNearest(scale) on NHWC."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        s = self.scale
        return x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)


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


class Residual(nn.Module):
    """models.createResidual (models.lua:8-55): the ``inner`` path plus the
    ``shortcut`` (Identity, or a 1x1-conv reducer), summed."""

    def __init__(self, inner: nn.Module, shortcut: nn.Module):
        super().__init__()
        self.inner = inner
        self.shortcut = shortcut

    def forward(self, x):
        return self.inner(x) + self.shortcut(x)


# ------------------------------------------------------------- StyleGAN2
#
# The generator of Karras et al., "Analyzing and Improving the Image Quality
# of StyleGAN" (arXiv:1912.04958; NVlabs/stylegan2, training/
# networks_stylegan2.py and dnnlib/tflib/ops/upfirdn_2d.py), under the
# conventions above: NHWC, HWIO and (in, out) kernels, operands rounded to
# ``dtype`` with f32 products and sums, each layer's output held in
# ``dtype``. Weights are stored as the official code stores them (before
# the equalized learning rate's runtime scale); they are zero until loaded.

_SQRT2 = math.sqrt(2.0)
_LRELU_SLOPE = 0.2
_EPS = 1e-8
_MAPPING_LR_MUL = 0.01  # the mapping's equalized learning rate multiplier


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    """lrelu(0.2) times sqrt(2), the gain of StyleGAN2's ``fused_bias_act``."""
    return F.leaky_relu(x, _LRELU_SLOPE) * _SQRT2


class PixelNorm(nn.Module):
    """z / sqrt(mean(z^2) + 1e-8) over the last axis (``normalize_2nd_moment``),
    in f32, held in ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype

    def forward(self, z):
        zf = z.float()
        return (zf * torch.rsqrt((zf * zf).mean(dim=-1, keepdim=True) + _EPS)
                ).to(self.dtype)


class EqualDense(nn.Module):
    """StyleGAN2's dense layer with the equalized learning rate: the kernel
    (in, out) and the bias are used at ``kernel * lr_mul / sqrt(in)`` and
    ``bias * lr_mul``; ``act="lrelu"`` adds lrelu(0.2) * sqrt(2)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, lr_mul: float = 1.0,
                 act: str = "linear"):
        super().__init__()
        if act not in ("linear", "lrelu"):
            raise ValueError(f"EqualDense act {act!r}: expected linear or "
                             "lrelu")
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.gain = lr_mul / math.sqrt(in_features)
        self.lr_mul = lr_mul
        self.act = act
        self.dtype = dtype

    def forward(self, x):
        y = (dense(x, self.kernel * self.gain, self.dtype)
             + self.bias * self.lr_mul)
        return (_lrelu(y) if self.act == "lrelu" else y).to(self.dtype)


class FIRFilter(nn.Module):
    """The 2-D FIR filter f (x) f of each of ``channels`` channels, f the
    taps [1, 3, 3, 1], normalised to sum 1 and the 2-D filter scaled by 4,
    the gain of a 2x up-sampling (upfirdn_2d's ``_setup_kernel``).
    ``up=1``: the blur after an up-sampling convolution, pad (1, 1): 2r + 1
    rows in, 2r out. ``up=2``: ``upsample_2d``, a zero after each pixel,
    pad (2, 1), the filter: r rows in, 2r out. The input rounded to
    ``dtype``, f32 result; forward and backward on the hand-written kernel
    on the card (``ops/fir_kernel.py::fir_filter``)."""

    def __init__(self, channels: int, up: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if up not in (1, 2):
            raise ValueError(f"FIRFilter up {up}: expected 1 or 2")
        self.up = up
        self.channels = channels
        self.dtype = dtype

    def forward(self, x):
        return fir_filter(x, self.up, self.dtype)


class ModulatedConv(nn.Module):
    """StyleGAN2's modulated convolution (``modulated_conv2d_layer``) in the
    form its paper gives as equivalent: the input scaled by the style s =
    A(w) per sample and input channel, the convolution with the shared
    weight at its runtime scale 1 / sqrt(Ci k k) and, with ``demodulate``,
    the output scaled per sample and output channel by d_o = 1 / sqrt(
    sum_i s_i^2 sum_k w_{o,i,k}^2 + 1e-8): the convolution with the
    per-sample weight d s w, which is never built. ``up``: the same weight
    as a stride-2 transposed convolution (2r + 1 outputs), then the FIR blur
    scaled by 4, pad (1, 1) (``upsample_conv_2d``): output 2r. The affine A
    is an :class:`EqualDense` from w to Ci, its bias the style's (1 at
    StyleGAN2's init). f32 result."""

    def __init__(self, in_ch: int, features: int, kernel: int, w_dim: int,
                 dtype: torch.dtype = torch.float32, demodulate: bool = True,
                 up: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel, kernel, in_ch,
                                               features))
        self.affine = EqualDense(w_dim, in_ch, dtype)
        self.blur = FIRFilter(features, 1, dtype) if up else None
        self.gain = 1.0 / math.sqrt(in_ch * kernel * kernel)
        self.demodulate = demodulate
        self.dtype = dtype

    def forward(self, x, w):
        s = self.affine(w)
        xs = x.to(self.dtype) * s[:, None, None, :]
        k = self.kernel * self.gain
        if self.blur is not None:
            y = self.blur(conv_transpose2_nhwc(xs, k, 0, self.dtype))
        else:
            y = conv_nhwc(xs, k, (k.shape[0] - 1) // 2, self.dtype)
        if self.demodulate:
            d = torch.rsqrt(dense(s.float() ** 2, (k * k).sum(dim=(0, 1)),
                                  self.dtype) + _EPS)
            y = y * d[:, None, None, :]
        return y


class SynthesisLayer(ModulatedConv):
    """A demodulated 3x3 :class:`ModulatedConv` (``up`` as there), then
    + strength * noise (one fixed H x W map, StyleGAN2's "const" noise
    mode; ``noise`` is a buffer, ``strength`` a learned scalar), + bias,
    lrelu(0.2) * sqrt(2); held in ``dtype``."""

    def __init__(self, in_ch: int, features: int, res: int, w_dim: int,
                 dtype: torch.dtype = torch.float32, up: bool = False):
        super().__init__(in_ch, features, 3, w_dim, dtype, True, up)
        self.bias = nn.Parameter(torch.zeros(features))
        self.strength = nn.Parameter(torch.zeros(()))
        self.register_buffer("noise", torch.zeros(res, res))

    def forward(self, x, w):
        y = (super().forward(x, w) + self.strength * self.noise[:, :, None]
             + self.bias)
        return _lrelu(y).to(self.dtype)


class ToRGB(ModulatedConv):
    """A modulated 1x1 convolution to the image's channels, without
    demodulation, plus a bias; f32 result."""

    def __init__(self, in_ch: int, w_dim: int, channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, channels, 1, w_dim, dtype, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, w):
        return super().forward(x, w) + self.bias


class SynthesisBlock(nn.Module):
    """One resolution of StyleGAN2's skip generator. At 4 x 4: the learned
    constant (``const``, H x W x C), one :class:`SynthesisLayer` and
    :class:`ToRGB`. Above: an up-sampling layer (``conv0``), a layer
    (``conv1``) and ToRGB; the image so far, up-sampled by the FIR
    (``upsample_2d``, gain 4), plus ToRGB's output is the new image.
    ``forward(x, y, w) -> (x, y)``, features and image held in ``dtype``."""

    def __init__(self, in_ch: int, features: int, res: int, w_dim: int,
                 image_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if res == 4:
            self.const = nn.Parameter(torch.zeros(res, res, features))
            self.conv = SynthesisLayer(features, features, res, w_dim, dtype)
        else:
            self.conv0 = SynthesisLayer(in_ch, features, res, w_dim, dtype,
                                        up=True)
            self.conv1 = SynthesisLayer(features, features, res, w_dim,
                                        dtype)
            self.skip = FIRFilter(image_channels, 2, dtype)
        self.torgb = ToRGB(features, w_dim, image_channels, dtype)

    def forward(self, x, y, w):
        if y is None:
            x = self.const.to(self.dtype).expand(w.shape[0],
                                                 *self.const.shape)
            x = self.conv(x, w)
            return x, self.torgb(x, w).to(self.dtype)
        x = self.conv1(self.conv0(x, w), w)
        return x, (self.skip(y) + self.torgb(x, w)).to(self.dtype)


class StyleGenerator(nn.Module):
    """StyleGAN2's generator (``G_mapping`` + ``G_synthesis_stylegan2``,
    the skip architecture), z (N, noise_dim) -> images (N, H, W, C) in
    ``dtype``, at truncation 1 and without style mixing.

    ``mapping``: :class:`PixelNorm`, then ``mapping_layers`` dense layers
    with lrelu and the equalized learning rate at lr_mul 0.01, giving w,
    which every layer's style takes (``l1`` ... are the dense layers).
    Blocks ``b4``, ``b8``, ... up to H, with min(2 channel_base / r,
    channel_max) channels at resolution r. Spans (io/metrics.py::span):
    ``gr.sg2.mapping`` and one ``gr.sg2.b<r>`` a block."""

    def __init__(self, dimensions, noise_dim: int, w_dim: int,
                 dtype: torch.dtype = torch.float32, mapping_layers: int = 8,
                 channel_base: int = 16384, channel_max: int = 512):
        super().__init__()
        c, h, w = dimensions
        if h != w or h < 4 or h & (h - 1):
            raise ValueError(f"StyleGAN2 needs a square power-of-two image "
                             f"of at least 4 x 4, got {h} x {w}")
        self.mapping = Sequential([PixelNorm(dtype)] + [
            EqualDense(noise_dim if i == 0 else w_dim, w_dim, dtype,
                       _MAPPING_LR_MUL, "lrelu")
            for i in range(mapping_layers)])
        res, in_ch = 4, None
        while res <= h:
            ch = min(2 * channel_base // res, channel_max)
            self.add_module(f"b{res}", SynthesisBlock(
                in_ch, ch, res, w_dim, c, dtype))
            res, in_ch = 2 * res, ch

    def blocks(self):
        """(name, block) of the synthesis blocks, from 4 x 4 up."""
        return [(n, m) for n, m in self.named_children()
                if isinstance(m, SynthesisBlock)]

    def forward(self, z):
        with span("gr.sg2.mapping"):
            w = self.mapping(z)
        x = y = None
        for name, block in self.blocks():
            with span(f"gr.sg2.{name}"):
                x, y = block(x, y, w)
        return y


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every Dense, Conv and BatchNorm of ``module`` by its own init
    attributes, in module order, from ``generator``."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv, BatchNorm)):
            m.reset_parameters(generator)
    return module


def _leaves(tree):
    """(name, array-like) leaves of a module, a tensor or a nested
    dict/list/tuple of arrays or tensors."""
    if isinstance(tree, nn.Module):
        yield from tree.named_parameters()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            for name, leaf in _leaves(v):
                yield (f"{k}.{name}" if name else str(k)), leaf
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for name, leaf in _leaves(v):
                yield (f"{i}.{name}" if name else str(i)), leaf
    elif tree is not None:
        yield "", tree


def _size(leaf) -> int:
    return int(leaf.numel() if isinstance(leaf, torch.Tensor)
               else np.size(leaf))


def count_parameters(params) -> int:
    """NN_UTILS.getNumberOfParameters, counting every learnable leaf (the
    reference counts only ``.weight`` tensors, nn_utils.lua:417-426) of a
    module or a tree of arrays or tensors."""
    return sum(_size(leaf) for _, leaf in _leaves(params))


def count_weight_parameters(params) -> int:
    """The reference's count: only weight/kernel/scale/alpha leaves, no
    biases (nn_utils.lua:417-426 counts modules' ``.weight``, which
    includes BatchNorm's scale and PReLU's alpha in torch)."""
    return sum(_size(leaf) for name, leaf in _leaves(params)
               if any(k in name.rsplit(".", 1)[-1]
                      for k in ("kernel", "scale", "alpha")))
