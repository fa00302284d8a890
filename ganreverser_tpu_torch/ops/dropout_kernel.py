"""Kernel B5: dropout with a counter-hash mask computed inside the pass,
forward and backward — the counterpart of ganreverser_tpu/ops/
dropout_kernel.py (``fused_dropout``, its custom_vjp and ``_run``).

Each element's random bits are the murmur3 finalizer of its flat index (mod
2^32) xor the seed times 0x9E3779B9; the element is kept when the bits fall
below ``round(keep * 2^32)`` and then scaled by ``1 / keep`` rounded to f32,
in one f32 multiply, and rounded back to the input's dtype. The stream is a
function of the source alone, so the port's masks are bit for bit the JAX
kernel's for the same int32 seed and shape. The gradient is dropout of the
incoming gradient with the same seed: the mask is regenerated, never stored.

``base`` (the counter base) is added to every flat index before it is
hashed: a tensor that holds rows [r, r + n) of a batch takes the first
row's flat index, ``r * (elements per row)``, and its mask is those rows
of the whole batch's mask, bit for bit (a rank's part of a batch cut over
the mesh's 'data' axis, models/modules.py). The JAX package has no such
base: under a mesh it draws threefry masks instead. At base 0 the mask is
the JAX kernel's.

``fused_dropout`` launches the CUDA kernel (``csrc/dropout.cu``) on CUDA
tensors, its backward too (``fused_dropout.launches`` counts both;
``fused_dropout.copies`` counts the non-contiguous tensors or gradients it
had to copy first), and takes the plain version ``fused_dropout_plain`` on
CPU tensors; no other device is accepted. The launch's threshold,
multiplier and dtype code are computed once per (rate, dtype)
(:func:`dropout_plan`). Unlike the TPU wrapper's ``supports`` gate (size % 8192), any size
is taken: the hash of the flat index does not depend on a tiling.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib

_GOLDEN = 0x9E3779B9
_MIX1, _MIX2 = 0x85EBCA6B, 0xC2B2AE35
_MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """uint32 threshold: bits below it are kept, P = 1 - rate (the TPU
    wrapper's ``min(round(keep * 2^32), 2^32 - 1)``)."""
    return min(int(round((1.0 - rate) * 4294967296.0)), 4294967295)


def inv_keep_f32(rate: float) -> float:
    """The survivors' multiplier, ``1 / (1 - rate)`` rounded to f32."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32), split in 16-bit halves of
    c so that no product leaves int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def hash_bits(n: int, seed: torch.Tensor, device,
              base: int = 0) -> torch.Tensor:
    """The kernel's uint32 bits of flat indices base..base+n-1, as
    int64."""
    idx = (torch.arange(n, dtype=torch.int64, device=device) + base) \
        & _MASK32
    h = idx ^ _mul32(seed.reshape(()).to(torch.int64) & _MASK32, _GOLDEN)
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


def fused_dropout_plain(x: torch.Tensor, seed: torch.Tensor,
                        rate: float, base: int = 0) -> torch.Tensor:
    """Plain PyTorch version on any device, with plain autograd: the same
    hash in int64 arithmetic masked to 32 bits, the same f32 multiply."""
    keep = hash_bits(x.numel(), seed, x.device, base).reshape(x.shape) < \
        keep_threshold(rate)
    return torch.where(keep, x.float() * inv_keep_f32(rate), 0.0).to(x.dtype)


class DropoutPlan(NamedTuple):
    code: int        # dtype code of the C interface
    thresh: int      # keep_threshold(rate)
    inv_keep: float  # inv_keep_f32(rate)


@functools.lru_cache(maxsize=None)
def dropout_plan(rate: float, dtype: torch.dtype) -> DropoutPlan:
    """The launch's scalars for (rate, dtype), computed once per pair."""
    return DropoutPlan(cuda_lib.DTYPE_CODES[dtype], keep_threshold(rate),
                       inv_keep_f32(rate))


def _launch(x: torch.Tensor, seed: torch.Tensor, rate: float,
            base: int) -> torch.Tensor:
    if not x.is_contiguous():
        x = x.contiguous()
        fused_dropout.copies += 1
    dev = x.device
    cuda_lib.dtype_code(x)
    plan = dropout_plan(rate, x.dtype)
    seed = seed.reshape(1)
    cuda_lib.require(seed, "seed", dev, torch.int32, (1,))
    y = torch.empty_like(x)
    args = (plan.code, x.data_ptr(), y.data_ptr(), seed.data_ptr(),
            x.numel(), base & _MASK32, plan.thresh, plan.inv_keep,
            cuda_lib.stream_of(x))
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_fused_dropout(*args)
    cuda_lib.check(rc, "fused_dropout")
    fused_dropout.launches += 1
    return y


class _FusedDropout(torch.autograd.Function):
    """The kernel forward; the backward saves only the seed and launches
    the kernel again on the gradient (the TPU wrapper's ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, seed, rate, base):
        ctx.save_for_backward(seed)
        ctx.rate, ctx.base = rate, base
        return _launch(x, seed, rate, base)

    @staticmethod
    def backward(ctx, grad):
        (seed,) = ctx.saved_tensors
        return _launch(grad, seed, ctx.rate, ctx.base), None, None, None


def fused_dropout(x: torch.Tensor, seed: torch.Tensor, rate: float,
                  base: int = 0) -> torch.Tensor:
    """Dropout(rate) of ``x`` (f32 or bf16 on CUDA) with the mask of the
    int32 ``seed`` (one element, on x's device) and the counter base
    ``base`` (module docstring); differentiable in x."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if seed.numel() != 1 or seed.dtype != torch.int32:
        raise ValueError(f"seed must be one int32, got {seed.dtype} "
                         f"{tuple(seed.shape)}")
    if base < 0:
        raise ValueError(f"counter base {base} is negative")
    if cuda_lib.dispatch_device(x, seed) == "cpu":
        return fused_dropout_plain(x, seed, rate, base)
    if not (x.requires_grad and torch.is_grad_enabled()):
        return _launch(x, seed, rate, base)  # no graph to record
    return _FusedDropout.apply(x, seed, rate, base)


cuda_lib.counted(fused_dropout)
fused_dropout.copies = 0   # non-contiguous inputs copied before a launch


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One int32 seed (shape (1,)) drawn on ``device`` from ``generator``,
    with no host sync."""
    return torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                         generator=generator, device=device)
