"""Kernel B7: a 3x3 SAME conv with a training BatchNorm's per-channel
statistics taken in the same pass — the counterpart of
benchmarks/convbn_probe.py's ``conv_stats`` (its Pallas ``conv_stats_kernel``).

``conv_stats(x, kernel) -> (y, sum, sumsq)``: y (N,H,W,Co) f32, the conv
of ``x`` with ``kernel`` rounded to ``x.dtype`` and summed in f32, and
``sum``/``sumsq`` (Co,) f32 over N*H*W. On CUDA tensors it launches
``csrc/conv_stats.cu`` (the conv with per-block partial sums in its
epilogue, then a fixed-order reduction over blocks: no float atomics, two
runs are bitwise equal): bf16 on the tensor-core tile with kernel B's
operands (``conv_operands``), f32 on the CUDA cores. On CPU tensors it
takes :func:`conv_stats_plain`. ``conv_stats.launches`` counts the calls
that launched it.

:func:`tile_partials_plain` and :func:`finish_plain` are the bf16 kernel's
statistics in its order (per 128-pixel tile, then over tiles), for the
tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import conv_operands, cuda_lib
from .upsample_conv import conv_nhwc

_ROWS_PER_BLOCK = 64   # csrc/conv_tile.cuh's kBM: the f32 route's partials
_FINISH_THREADS = 256  # csrc/conv_stats.cu's kFinishThreads


def conv_stats_plain(x: torch.Tensor, kernel: torch.Tensor):
    """Plain PyTorch version on any device: the conv with operands rounded
    to ``x.dtype`` and f32 sums, then the per-channel sums of y and y^2."""
    y = conv_nhwc(x, kernel, 1, x.dtype)
    return y, y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2))


def _pairwise(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sums of ``v`` over ``dim`` (of size 2^k) as the butterfly of
    __shfl_xor_sync over rising lane bits adds them: neighbours first."""
    while v.shape[dim] > 1:
        v = v.unflatten(dim, (-1, 2))
        v = v.select(dim + 1, 0) + v.select(dim + 1, 1)
    return v


def tile_partials_plain(y: torch.Tensor, bh: int, bw: int):
    """Per-tile channel sums and sums of squares of y (N,H,W,Co) f32 in the
    tensor-core kernel's order: tiles of bh x bw pixels (pixels outside the
    image add 0), row r = (r // bw, r % bw) of a tile; each warp w of 8
    owns rows 16w .. 16w + 15, each of its 8 lane groups k rows 16w + k and
    16w + k + 8 (added first), the 8 groups added as a butterfly, then the
    warps in order. Returns (sum, sumsq), each (Co, tiles) f32, tiles
    image-major, then tile rows, then tile columns."""
    n, h, w, co = y.shape
    th, tw = -(-h // bh), -(-w // bw)
    yp = F.pad(y.float(), (0, 0, 0, tw * bw - w, 0, th * bh - h))
    rows = (yp.reshape(n, th, bh, tw, bw, co).permute(0, 1, 3, 2, 4, 5)
            .reshape(n * th * tw, 8, 2, 8, co))   # tile, warp, half, k, co
    out = []
    for v in (rows[:, :, 0] + rows[:, :, 1],
              rows[:, :, 0] * rows[:, :, 0] + rows[:, :, 1] * rows[:, :, 1]):
        per_warp = _pairwise(v, 2)[:, :, 0]      # tile, warp, co
        total = per_warp[:, 0]
        for warp in range(1, 8):
            total = total + per_warp[:, warp]
        out.append(total.T.contiguous())
    return tuple(out)


def finish_plain(part_sum: torch.Tensor, part_sq: torch.Tensor):
    """``conv_stats_finish_kernel``'s order over (Co, blocks) partials:
    thread t of 256 adds blocks t, t + 256, ... in turn, then the 256
    threads' sums as a tree of halves. Returns (sum, sumsq), each (Co,)."""
    out = []
    for part in (part_sum, part_sq):
        co, nb = part.shape
        m = -(-nb // _FINISH_THREADS)
        p = F.pad(part.float(), (0, m * _FINISH_THREADS - nb))
        p = p.reshape(co, m, _FINISH_THREADS)
        red = torch.zeros((co, _FINISH_THREADS), dtype=torch.float32,
                          device=part.device)
        for i in range(m):
            red = red + p[:, i]
        half = _FINISH_THREADS // 2
        while half:
            red = red[:, :half] + red[:, half:2 * half]
            half //= 2
        out.append(red[:, 0])
    return tuple(out)


def conv_stats(x: torch.Tensor, kernel: torch.Tensor):
    """x: (N,H,W,Ci) NHWC, f32 or bf16; kernel: (3,3,Ci,Co) HWIO. Returns
    (y (N,H,W,Co) f32, sum (Co,) f32, sumsq (Co,) f32)."""
    if cuda_lib.dispatch_device(x, kernel) == "cpu":
        return conv_stats_plain(x, kernel)
    code = cuda_lib.dtype_code(x)
    n, h, w, ci = x.shape
    co = kernel.shape[-1]
    if tuple(kernel.shape[:3]) != (3, 3, ci):
        raise ValueError(f"conv_stats: kernel {tuple(kernel.shape)} does not "
                         f"take the input's {ci} channels")
    if x.dtype == torch.bfloat16:  # the tensor-core tile's operands
        xk = conv_operands.pad_channels(x)
        wk = conv_operands.conv3x3_weights(kernel, x.dtype)
        plan = conv_operands.tile_plan(h, w, ci, co, out_bytes=4)
        wshape = (9, co, xk.shape[-1])
        nblocks = n * -(-h // plan.bh) * -(-w // plan.bw)
    else:
        xk, plan = x, conv_operands.NO_PLAN
        wk = kernel.to(x.dtype).reshape(9, ci, co).contiguous()
        wshape = (9, ci, co)
        nblocks = -(-n * h * w // _ROWS_PER_BLOCK)
    cuda_lib.require(xk, "x", x.device, x.dtype, (n, h, w, xk.shape[-1]))
    cuda_lib.require(wk, "kernel", x.device, x.dtype, wshape)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((n, h, w, co), **f32)
    ws = torch.empty(2 * co * nblocks, **f32)
    s = torch.empty(co, **f32)
    q = torch.empty(co, **f32)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_conv_stats(
            code, xk.data_ptr(), wk.data_ptr(), y.data_ptr(), ws.data_ptr(),
            s.data_ptr(), q.data_ptr(), n, h, w, xk.shape[-1], co, *plan,
            cuda_lib.stream_of(x))
    cuda_lib.check(rc, "conv_stats")
    conv_stats.launches += 1
    return y, s, q


cuda_lib.counted(conv_stats)
