"""Nearest-upsample(2x) + 3x3 conv as plain PyTorch (the lhs-dilated
formulation of ganreverser_tpu/ops/upsample_conv.py), plus the NHWC
convolution helper the plain paths share.

A 3x3 window over a nearest-upsampled image sees only 2x2 distinct input
pixels, with tap weights that depend on the output pixel's parity:

  output row 2r   (py=0): input rows (r-1, r) with y-weights (W0, W1+W2)
  output row 2r+1 (py=1): input rows (r, r+1) with y-weights (W0+W1, W2)

(same along x). ``upsample2_conv3x3_dilated`` writes both parities as one
conv over the zero-inserted input with the 4-tap kernel [w0, w0+w1, w1+w2,
w2]. The four per-parity 2x2 convs live in ops/upsample_conv_kernel.py
(``phase_kernels``), the layout of kernel U.

Every convolution here takes operands rounded to ``dtype`` and accumulates
in f32, as the JAX package's ``preferred_element_type=float32`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.precision import pinned_precision

# (4, 3) tap-aggregation map of the lhs-dilated formulation
_A4 = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 1.0, 1.0), (0.0, 0.0, 1.0))


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


def upsample2_conv3x3_dilated(x, kernel, bias, dtype=torch.float32):
    """One conv over the zero-inserted input with the aggregated 4x4 kernel
    (taps summed in f32, rounded to ``dtype`` once)."""
    a = torch.tensor(_A4, dtype=torch.float32, device=kernel.device)
    w4 = torch.einsum("ay,bx,yxio->abio", a, a, kernel.float())
    n, h, w, c = x.shape
    xd = x.new_zeros((n, 2 * h - 1, 2 * w - 1, c))
    xd[:, ::2, ::2, :] = x
    return (conv_nhwc(xd, w4, 2, dtype) + bias.float()).to(dtype)
