"""The work the models need: operations and bytes per layer, and the least
time the card could take for them.

The arithmetic is that of ``chip_smoke.py``'s ``bound()`` and kernel
cases, extended to D2 and to the backward passes:

* a dense layer of I inputs and O outputs takes 2 I O operations an image;
* a k x k convolution of Ci to Co channels at an output of H x W takes
  2 H W k k Ci Co;
* a nearest-upsample by 2 followed by a 3 x 3 convolution touches only 4
  distinct input pixels at each output phase, so it is counted at 4 taps,
  2 (2h)(2w) 4 Ci Co for an h x w input: the necessary work, whatever a
  kernel computes;
* a backward pass to the inputs costs what the forward costs, and so does
  the one to the weights;
* bytes count each input read once and each output written once.

A share of a peak from these counts cannot pass 100 % unless the time
leaves out part of the work.
"""
from __future__ import annotations

import math
from typing import NamedTuple

# one H100 SXM's published bf16 peak (dense, no sparsity) and memory rate
PEAK_FLOPS = 989e12
MEM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2
F32_BYTES = 4


class Layer(NamedTuple):
    """One layer's work for one image: ``flops`` of its forward (necessary
    count), the elements of its input, weights and output (the output after
    a pool the layer carries), and its output channels."""
    name: str
    flops: int
    in_elems: int
    w_elems: int
    out_elems: int
    channels: int


def dense(name: str, i: int, o: int) -> Layer:
    return Layer(name, 2 * i * o, i, i * o, o, o)


def conv(name: str, h: int, w: int, ci: int, co: int, k: int = 3,
         pool: bool = False) -> Layer:
    out = (h // 2) * (w // 2) * co if pool else h * w * co
    return Layer(name, 2 * h * w * k * k * ci * co, h * w * ci,
                 k * k * ci * co, out, co)


def upconv(name: str, h: int, w: int, ci: int, co: int) -> Layer:
    """Upsample by 2 of an h x w input, then a 3 x 3 convolution: 4 taps
    per output phase."""
    return Layer(name, 2 * (2 * h) * (2 * w) * 4 * ci * co, h * w * ci,
                 9 * ci * co, 4 * h * w * co, co)


def g3_layers(image: tuple, noise_dim: int) -> list:
    """G3 (models.lua:104-143): Dense to 512 maps of H/4 x W/4, two upsample
    stages to 256 and 128 maps, a 3 x 3 convolution to C."""
    c, h, w = image
    sh, sw = h // 4, w // 4
    return [dense("G.dense", noise_dim, 512 * sh * sw),
            upconv("G.up1", sh, sw, 512, 256),
            upconv("G.up2", 2 * sh, 2 * sw, 256, 128),
            conv("G.head", h, w, 128, c)]


def r_layers(image: tuple, noise_dim: int) -> list:
    """R_default (models.lua:389-464): two blocks of three 3 x 3
    convolutions and a pool, Dense 512, Dense noise_dim."""
    c, h, w = image
    return [conv("R.conv1", h, w, c, 64), conv("R.conv2", h, w, 64, 64),
            conv("R.conv3", h, w, 64, 64, pool=True),
            conv("R.conv4", h // 2, w // 2, 64, 128),
            conv("R.conv5", h // 2, w // 2, 128, 128),
            conv("R.conv6", h // 2, w // 2, 128, 128, pool=True),
            dense("R.dense1", 128 * (h // 4) * (w // 4), 512),
            dense("R.dense2", 512, noise_dim)]


def d2_layers(image: tuple) -> list:
    """D2 (models.lua:272-337): a stem of two 3 x 3 convolutions and a
    pool, a left branch (5 x 5 convolution, pool, Dense 512) and a right one
    (3 x 3, pool, two 3 x 3, pool, Dense 512), Dense 256, Dense 1."""
    c, h, w = image
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    return [conv("D.stem1", h, w, c, 128), conv("D.stem2", h, w, 128, 128,
                                                pool=True),
            conv("D.left", h2, w2, 128, 64, k=5, pool=True),
            dense("D.left_dense", 64 * h4 * w4, 512),
            conv("D.right1", h2, w2, 128, 128, pool=True),
            conv("D.right2", h4, w4, 128, 256),
            conv("D.right3", h4, w4, 256, 256, pool=True),
            dense("D.right_dense", 256 * (h // 8) * (w // 8), 512),
            dense("D.dense1", 1024, 256), dense("D.dense2", 256, 1)]


def forward_flops(layers: list) -> int:
    return sum(layer.flops for layer in layers)


def train_flops(layers: list, weights: bool, inputs_of_first: bool) -> int:
    """Forward and backward of one image: the forward, the backward to
    every layer's input (the first layer's only with ``inputs_of_first``)
    and, with ``weights``, to every layer's weights."""
    fwd = forward_flops(layers)
    back_in = fwd - (0 if inputs_of_first else layers[0].flops)
    return fwd + back_in + (fwd if weights else 0)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the work could take: the larger of the operations over
    the bf16 peak and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / MEM_BYTES_PER_S)


def layer_bound_s(layer: Layer, batch: int) -> float:
    """One launch of a layer over ``batch`` images: its operations, its
    input and output activations and its weights in bf16, and an f32 scale
    and shift per output channel (bias and BatchNorm folded into the
    epilogue)."""
    return fused_bound_s([layer], batch)


def fused_bound_s(layers: list, batch: int) -> float:
    """One launch that computes ``layers`` in sequence: their operations, the
    first one's input, every layer's weights and f32 scale and shift, and
    the last one's output; the activations between them stay inside the
    kernel."""
    flops = batch * forward_flops(layers)
    nbytes = ((batch * (layers[0].in_elems + layers[-1].out_elems)
               + sum(layer.w_elems for layer in layers)) * BF16_BYTES
              + sum(2 * layer.channels for layer in layers) * F32_BYTES)
    return bound_s(flops, nbytes)


def score_bound_s(q: int, n: int, d: int) -> float:
    """Cosine scores of ``q`` needles against ``n`` bf16 rows of ``d``: the
    products and the rows' norms, the rows and the needles' int64 indices
    read once and the (q, n) f32 scores written once (``chip_smoke.py``'s
    count for kernel C)."""
    return bound_s(2 * q * n * d + 2 * n * d, n * d * BF16_BYTES + q * 8
                   + q * n * F32_BYTES)


def needle_chunks(n: int, chunk: int) -> list:
    """The needle counts of a search of every row in chunks."""
    return [min(chunk, n - s) for s in range(0, n, chunk)]


def chunks(n: int, batch: int) -> int:
    return math.ceil(n / batch)
