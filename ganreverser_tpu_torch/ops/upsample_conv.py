"""Nearest-upsample(2x) + 3x3 conv as plain PyTorch: the lhs-dilated conv
of ganreverser_tpu/ops/upsample_conv.py, computed as a stride-2 transposed
conv, plus the NHWC convolution helper the plain paths share.

A 3x3 window over a nearest-upsampled image sees only 2x2 distinct input
pixels, with tap weights that depend on the output pixel's parity:

  output row 2r   (py=0): input rows (r-1, r) with y-weights (W0, W1+W2)
  output row 2r+1 (py=1): input rows (r, r+1) with y-weights (W0+W1, W2)

(same along x). The JAX package writes both parities as one conv over the
zero-inserted input with the 4-tap kernel [w0, w0+w1, w1+w2, w2] and
padding 2; ``upsample2_conv3x3_dilated`` computes that conv as what it is,
a stride-2 transposed convolution (``conv_transpose2_nhwc``, which
StyleGAN2's up-sampling convolutions share), which multiplies only the 2x2
taps of each output pixel that meet an input pixel and makes no
zero-filled input.
The four per-parity 2x2 convs live in ops/upsample_conv_kernel.py
(``phase_kernels``), the layout of kernel U.

Every convolution here takes operands rounded to ``dtype`` and accumulates
in f32, as the JAX package's ``preferred_element_type=float32`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.precision import pinned_precision


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, padding,
              dtype: torch.dtype) -> torch.Tensor:
    """Stride-1 cross-correlation of NHWC ``x`` with an HWIO ``kernel``,
    operands rounded to ``dtype``, f32 result. ``padding`` as F.conv2d's.
    The precision does not follow the process-wide TF32 flags
    (core/precision.py)."""
    xt = x.to(dtype).float().permute(0, 3, 1, 2)
    wt = kernel.to(dtype).float().permute(3, 2, 0, 1)
    with pinned_precision(dtype):
        y = F.conv2d(xt, wt, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2_nhwc(x: torch.Tensor, kernel: torch.Tensor, padding,
                         dtype: torch.dtype) -> torch.Tensor:
    """Stride-2 transposed convolution of NHWC ``x``: ``x`` with a zero
    between neighbouring pixels, cross-correlated over its full extent with
    the HWIO ``kernel``, ``padding`` rows and columns cropped from each
    side; a k x k kernel turns an r x r input into 2r - 1 + k - 1 - 2
    ``padding``. Operands rounded to ``dtype``, f32 result, at the
    precision :func:`conv_nhwc` pins."""
    xt = x.to(dtype).float().permute(0, 3, 1, 2)
    wt = kernel.to(dtype).float().flip(0, 1).permute(2, 3, 0, 1)
    with pinned_precision(dtype):
        y = F.conv_transpose2d(xt, wt, stride=2, padding=padding)
    return y.permute(0, 2, 3, 1)


def _tap_sums(w: torch.Tensor, dim: int) -> torch.Tensor:
    """[w0, w0+w1, w1+w2, w2] along ``dim`` of size 3: ``w`` with a zero
    after it plus ``w`` with a zero before it, all on ``w``'s device."""
    zero = torch.zeros_like(w.narrow(dim, 0, 1))
    return torch.cat([w, zero], dim) + torch.cat([zero, w], dim)


def upsample2_conv3x3_dilated(x, kernel, bias, dtype=torch.float32):
    """The lhs-dilated conv with the aggregated 4x4 kernel ``w4`` (taps
    summed in f32, along y then x, rounded to ``dtype`` once), run as the
    transposed convolution it is: stride 2, padding 1, ``w4`` flipped."""
    w4 = _tap_sums(_tap_sums(kernel.float(), 0), 1)
    y = conv_transpose2_nhwc(x, w4, 1, dtype)
    return (y + bias.float()).to(dtype)
