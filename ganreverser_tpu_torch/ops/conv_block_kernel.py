"""Kernel B: a chain of 3x3 conv + BN(eval) + activation layers with an
optional trailing 2x2 maxpool, R's conv blocks.

The counterpart of ganreverser_tpu/ops/conv_block_kernel.py. The TPU kernel
keeps a whole chain in VMEM; on this card neither the accumulator of a
64x64x64 image nor stage 2's weights fit in a block's shared memory, so
``conv_block`` launches the CUDA kernel (``csrc/conv_block.cu``) once per
layer, with the pool fused into the last layer's epilogue: bf16 on the
tensor cores (``csrc/conv_wgmma.cuh``), f32 on the CUDA cores. Semantics kept
from the TPU kernel: every layer's input is zero-padded at the image border
(each launch pads anew), each intermediate is rounded to ``x.dtype``, ELU is
``exp(min(y, 0)) - 1`` and the pool follows the last layer only.

``conv_block`` (the custom operator ``ganreverser::conv_block`` of
ops/library.py) launches the kernel on CUDA tensors and takes the plain
version ``conv_block_plain`` on CPU tensors; no other device is accepted.
``conv_block.launches`` counts kernel launches (one per layer).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from . import cuda_lib
from .conv_kernel import launch_conv3x3

_ACTS = ("elu", "relu", "none")


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "elu":
        return torch.where(y > 0, y, torch.exp(torch.clamp_max(y, 0.0)) - 1.0)
    if act == "none":
        return y
    raise ValueError(act)


def conv_block_plain(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                     scales: Sequence[torch.Tensor],
                     shifts: Sequence[torch.Tensor], *, act: str = "elu",
                     pool: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: per layer an f32
    conv of the ``x.dtype``-rounded operands, scale/shift, activation,
    rounding to ``x.dtype``; then the optional 2x2 maxpool."""
    y = x
    for k, sc, sh in zip(kernels, scales, shifts):
        wt = k.to(x.dtype).float().permute(3, 2, 0, 1)
        acc = F.conv2d(y.float().permute(0, 3, 1, 2), wt, padding=1)
        acc = acc.permute(0, 2, 3, 1) * sc.float() + sh.float()
        y = _act(acc, act).to(x.dtype)
    if pool:
        n, h, w, c = y.shape
        y = y.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    return y


def conv_block(x: torch.Tensor, kernels: Sequence[torch.Tensor],
               scales: Sequence[torch.Tensor], shifts: Sequence[torch.Tensor],
               *, act: str = "elu", pool: bool = False,
               operands: Sequence[torch.Tensor] | None = None
               ) -> torch.Tensor:
    """x: (N,H,W,C0) NHWC; kernels[i]: (3,3,Ci,Co) HWIO; scales/shifts[i]:
    (Co,) from fold_batchnorm. Returns (N,H,W,Ck), or (N,H/2,W/2,Ck) with
    ``pool``, in ``x.dtype``. Eval-mode only; N takes any value.
    ``operands``: each kernel laid out beforehand by
    ``conv_kernel.conv3x3_operand`` for ``x.dtype`` (the launches then
    skip the re-layout; the plain version reads ``kernels``). Runs as the
    custom operator ``ganreverser::conv_block`` (ops/library.py)."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    if not len(kernels) == len(scales) == len(shifts) or not kernels:
        raise ValueError("need one scale and shift per kernel, at least one")
    n, h, w, _ = x.shape
    if pool and (h % 2 or w % 2):
        raise ValueError(f"pool needs even H and W, got {h}x{w}")
    cuda_lib.dispatch_device(x, *kernels, *scales, *shifts)
    return torch.ops.ganreverser.conv_block(
        x, list(kernels), list(scales), list(shifts), act, pool,
        None if operands is None else list(operands))


def launch_conv_block(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                      scales: Sequence[torch.Tensor],
                      shifts: Sequence[torch.Tensor], act: str, pool: bool,
                      operands: Sequence[torch.Tensor] | None
                      ) -> torch.Tensor:
    """The body of ``ganreverser::conv_block``: one kernel launch per layer
    on CUDA tensors, the plain version on CPU tensors."""
    if cuda_lib.dispatch_device(x, *kernels, *scales, *shifts) == "cpu":
        return conv_block_plain(x, kernels, scales, shifts, act=act,
                                pool=pool)
    if operands is None:
        operands = [None] * len(kernels)
    y = x
    for li, (k, sc, sh, wk) in enumerate(zip(kernels, scales, shifts,
                                             operands)):
        y = launch_conv3x3(y, k, sc, sh, act=act,
                           pool=pool and li == len(kernels) - 1,
                           name="conv_block", operand=wk)
        conv_block.launches += 1
    return y


cuda_lib.counted(conv_block)
