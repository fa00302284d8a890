"""Kernel B7: a 3x3 SAME conv with a training BatchNorm's per-channel
statistics taken in the same pass — the counterpart of
benchmarks/convbn_probe.py's ``conv_stats`` (its Pallas ``conv_stats_kernel``).

``conv_stats(x, kernel) -> (y, sum, sumsq)``: y (N,H,W,Co) f32, the conv
of ``x`` with ``kernel`` rounded to ``x.dtype`` and summed in f32, and
``sum``/``sumsq`` (Co,) f32 over N*H*W. On CUDA tensors it launches
``csrc/conv_stats.cu`` (the conv with the partial sums in its epilogue,
then a fixed-order reduction over blocks: no float atomics, two runs are
bitwise equal); on CPU tensors it takes :func:`conv_stats_plain`.
``conv_stats.launches`` counts the calls that launched it.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .upsample_conv import conv_nhwc

_ROWS_PER_BLOCK = 64  # csrc/conv_tile.cuh's kBM: one partial per 64 pixels


def conv_stats_plain(x: torch.Tensor, kernel: torch.Tensor):
    """Plain PyTorch version on any device: the conv with operands rounded
    to ``x.dtype`` and f32 sums, then the per-channel sums of y and y^2."""
    y = conv_nhwc(x, kernel, 1, x.dtype)
    return y, y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2))


def conv_stats(x: torch.Tensor, kernel: torch.Tensor):
    """x: (N,H,W,Ci) NHWC, f32 or bf16; kernel: (3,3,Ci,Co) HWIO. Returns
    (y (N,H,W,Co) f32, sum (Co,) f32, sumsq (Co,) f32)."""
    if cuda_lib.dispatch_device(x, kernel) == "cpu":
        return conv_stats_plain(x, kernel)
    n, h, w, ci = x.shape
    co = kernel.shape[-1]
    w9 = kernel.to(x.dtype).reshape(9, ci, co).contiguous()
    cuda_lib.require(x, "x", x.device, x.dtype, (n, h, w, ci))
    cuda_lib.require(w9, "kernel", x.device, x.dtype, (9, ci, co))
    nblocks = -(-n * h * w // _ROWS_PER_BLOCK)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((n, h, w, co), **f32)
    ws = torch.empty(2 * co * nblocks, **f32)
    s = torch.empty(co, **f32)
    q = torch.empty(co, **f32)
    with torch.cuda.device(x.device):
        rc = cuda_lib.library().gr_conv_stats(
            cuda_lib.dtype_code(x), x.data_ptr(), w9.data_ptr(),
            y.data_ptr(), ws.data_ptr(), s.data_ptr(), q.data_ptr(), n, h, w,
            ci, co, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "conv_stats")
    conv_stats.launches += 1
    return y, s, q


conv_stats.launches = 0
