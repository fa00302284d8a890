"""Lane-packed small-Co convolution, the counterpart of
ganreverser_tpu/ops/pack_conv.py: G's output conv (models.lua:132-133, a
3x3 conv 128 -> C + sigmoid, C = 3 or 1) written as one strided conv onto
ph x pw blocks of output pixels.

A block of ph x pw output pixels of a SAME 3x3 conv reads one input
window of (ph + 2) x (pw + 2) pixels, so the conv is exactly one conv of
window (ph + 2, pw + 2) and stride (ph, pw) with Co' = ph * pw * C output
channels, whose block kernel holds the 3x3 kernel shifted to each offset:

  W'[ky, kx, ci, (pi, pj, c)] = W[ky - pi, kx - pj, ci, c]  (0 <= ky - pi < 3)

and the packed result unpacks with one reshape and transpose. The JAX
package computes it with XLA outside any Pallas kernel, so the port's conv
is ``F.conv2d`` (through ``upsample_conv.conv_nhwc``'s precision: operands
rounded to ``dtype``, f32 sums, the precision pinned by
core/precision.py), as it computes the unpacked head. On an H100 the
strided conv onto ph * pw * C channels is slower than the unpacked head
(``chip_smoke.py`` phase 13's A/B; PERF.md), so nothing uses it by
default (``models/fastpath.py::make_fast_generator(pack_out=...)``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.precision import pinned_precision


def pack_kernel(kernel: torch.Tensor, pack: Tuple[int, int]) -> torch.Tensor:
    """(kh, kw, Ci, Co) HWIO -> the (kh + ph - 1, kw + pw - 1, Ci,
    ph * pw * Co) block kernel, f32, output channels ordered (pi, pj, c)."""
    ph, pw = pack
    kh, kw, ci, co = kernel.shape
    big = kernel.new_zeros((kh + ph - 1, kw + pw - 1, ci, ph, pw, co),
                           dtype=torch.float32)
    w = kernel.float()
    for pi in range(ph):
        for pj in range(pw):
            big[pi:pi + kh, pj:pj + kw, :, pi, pj, :] += w
    return big.reshape(kh + ph - 1, kw + pw - 1, ci, ph * pw * co)


def conv3x3_packed(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   pack: Tuple[int, int] = (4, 8), act: Optional[str] = None,
                   dtype: torch.dtype = torch.float32,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME 3x3 conv + bias (+ 'sigmoid', 'relu' or 'elu') of NHWC ``x``
    with its output computed in ph x pw pixel blocks. x: (N, H, W, Ci) with
    H % ph == 0 and W % pw == 0; kernel: (3, 3, Ci, Co) HWIO; bias: (Co,).
    Returns (N, H, W, Co) in ``dtype``: operands rounded to ``dtype``, sums,
    bias and activation in f32, one rounding at the end. ``packed``:
    ``pack_kernel(kernel, pack)`` made beforehand (a caller that runs the
    same weights over many chunks makes it once), else made here."""
    ph, pw = pack
    n, h, w, _ = x.shape
    kh, kw, _, co = kernel.shape
    if h % ph or w % pw:
        raise ValueError(f"geometry {h}x{w} not divisible by pack {pack}")
    if packed is None:
        packed = pack_kernel(kernel, pack)
    wb = packed.to(dtype).float().permute(3, 2, 0, 1)
    xt = x.to(dtype).float().permute(0, 3, 1, 2)
    with pinned_precision(dtype):
        y = F.conv2d(xt, wb, stride=(ph, pw), padding=(kh // 2, kw // 2))
    y = y.permute(0, 2, 3, 1) + bias.float().repeat(ph * pw)
    if act == "sigmoid":
        y = torch.sigmoid(y)
    elif act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "elu":
        y = F.elu(y)
    elif act is not None:
        raise ValueError(act)
    y = y.to(dtype).reshape(n, h // ph, w // pw, ph, pw, co)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, co)
