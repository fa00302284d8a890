"""Kernel D: the fast forwards' dense layers in bf16 on the tensor cores,
``y = act(x @ w + shift)`` rounded once to bf16 (``csrc/dense.cu``).

It replaces no TPU kernel: the JAX package leaves its dense layers to XLA,
and the fast forwards (models/fastpath.py) ran them as an f32
``torch.matmul`` of bf16-rounded operands (cuBLAS's f32 GEMMs on the CUDA
cores) and three f32 passes for the shift, the activation and the
rounding. The products of bf16 values are exact in f32, so the kernel's
bf16 ``wgmma`` with f32 sums computes the same products; only the order of
the f32 sums differs, and the epilogue applies the shift and the
activation in f32 and rounds once, the rounding points of that plain
arithmetic (``dense_act_plain``). What bounds it is bytes: G's first layer
at 128x128 streams a 268 MB weight a batch (csrc/dense.cu).

* ``dense_operand(k)`` lays a (K, M) kernel (a BatchNorm folded in) out as
  the kernel reads it, once, when a fast forward prepares its weights:
  (M, K') bf16, K-major, K' = ``conv_operands.padded_channels(K)`` (z of
  100 to 104), the padding zero. It holds half the bytes of the f32 copy
  of the rounded kernel that the plain product reads.
* ``dense_plan(n, k, m)`` chooses the launch from the shape alone, by
  Q3's ``quant.dense_plan`` under this kernel's ``DENSE_POLICY``: 128
  rows of x by BN columns, BN halved while the tiles leave SMs idle and K
  is short (R l31), K split over blocks where the tiles leave SMs idle
  and K is long (R l27), each split's f32 sums added in split order by a
  second launch; the ring deep where the grid is one block an SM.
* ``dense_act(x, operand, shift, act)``: the custom operator
  ``ganreverser::dense_act`` (ops/library.py); on CUDA tensors the
  kernel, on CPU tensors the plain version on the operand widened back to
  the (K, M) f32 kernel; it raises on operands it does not take, with no
  fallback. ``dense_act.launches`` counts its calls on the card (one or,
  under a split, two kernels each).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.precision import pinned_precision
from . import conv_operands, cuda_lib, quant

ACTS = ("none", "relu", "elu", "tanh")
# bf16 operands, BN up to 64, split from 16 stages of K, a bf16 output tile,
# the deep ring of a one-wave grid
DENSE_POLICY = quant.DensePolicy(2, 64, 4 * quant.DENSE_MIN_CHUNKS, 2, True)


def activation(y: torch.Tensor, act: str) -> torch.Tensor:
    """``act`` of the f32 ``y`` as the plain version applies it."""
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "elu":
        return F.elu(y)
    if act == "tanh":
        return torch.tanh(y)
    if act == "none":
        return y
    raise ValueError(act)


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def dense_act_plain(x: torch.Tensor, k: torch.Tensor, shift: torch.Tensor,
                    act: str = "none",
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch on any device: the f32
    product of ``x`` rounded to ``dtype`` and ``k``, a (K, M) kernel
    already rounded to ``dtype`` and held in f32, at the precision pinned
    for ``dtype``; ``+ shift`` in f32, ``act``, one rounding to
    ``dtype``."""
    with pinned_precision(dtype):
        y = x.to(dtype).float() @ k
    return activation(y + shift, act).to(dtype)


def dense_operand(k: torch.Tensor) -> torch.Tensor:
    """A (K, M) kernel as the kernel reads it: (M, K') bf16, K-major, K' =
    ``padded_channels(K)``, the padding zero."""
    return conv_operands.kmajor(k[None], torch.bfloat16)[0]


def operand_kernel(operand: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`dense_operand`'s (M, K') back as the (K, M) f32 kernel, the
    bf16 values widened, contiguous: what the plain product reads."""
    return operand[:, :k].float().T.contiguous()


def dense_plan(n: int, k: int, m: int):
    """The launch as (TilePlan, splits), from the shape alone: Q3's
    ``quant.dense_plan`` under ``DENSE_POLICY``. The tile is 1 x 128 rows
    of x by BN columns, BN the least width covering M up to 64 (three
    blocks an SM, the fastest of 16 to 256 at G l0 on an H100, PERF.md),
    BK the padded K's depth up to a 128-byte row. Where K is shorter than
    16 stages, BN is halved (down to 16) while the (N, M) tiles leave SMs
    idle (R l31); else K is split by ``quant.dense_splits`` where the
    tiles leave SMs idle (R l27). Where the grid is at most one block an
    SM the ring takes as many stages as the shared memory holds (R l27's
    splits stream K through 8)."""
    return quant.dense_plan(n, k, m, DENSE_POLICY)


def launch_dense_act(x: torch.Tensor, operand: torch.Tensor,
                     shift: torch.Tensor, act: str) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors: the
    body of the ``ganreverser::dense_act`` op."""
    _check_act(act)
    if x.dim() != 2 or operand.dim() != 2:
        raise ValueError(f"dense_act: x {tuple(x.shape)} and operand "
                         f"{tuple(operand.shape)} must be 2-D")
    n, k = x.shape
    m, kp = operand.shape
    if operand.dtype != torch.bfloat16 or kp != conv_operands.padded_channels(
            k):
        raise ValueError(
            f"dense_act: operand {tuple(operand.shape)} {operand.dtype} is "
            f"not a bf16 (M, K') operand of dense_operand for the input's "
            f"{k} features")
    if cuda_lib.dispatch_device(x, operand, shift) == "cpu":
        return dense_act_plain(x, operand_kernel(operand, k), shift, act)
    xk = conv_operands.pad_channels(x.to(torch.bfloat16))
    cuda_lib.require(xk, "x", x.device, torch.bfloat16, (n, kp))
    cuda_lib.require(operand, "operand", x.device, torch.bfloat16, (m, kp))
    sh = shift.float().reshape(-1).contiguous()
    cuda_lib.require(sh, "shift", x.device, torch.float32, (m,))
    plan, splits = dense_plan(n, k, m)
    part = (torch.empty((splits, n, m), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    out = torch.empty((n, m), dtype=torch.bfloat16, device=x.device)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_dense_bf16(
            xk.data_ptr(), operand.data_ptr(), sh.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), n, kp, m,
            cuda_lib.ACT_CODES[act], splits, *plan, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "dense_act")
    dense_act.launches += 1
    return out


@cuda_lib.counted
def dense_act(x: torch.Tensor, operand: torch.Tensor, shift: torch.Tensor,
              act: str = "none") -> torch.Tensor:
    """``act(x @ k + shift)`` rounded once to bf16, (N, M): x (N, K) in any
    float dtype (rounded to bf16), ``operand`` the (K, M) kernel ``k`` laid
    out by :func:`dense_operand`, shift (M,) f32, act one of ``ACTS``.
    Runs as the custom operator ``ganreverser::dense_act``
    (ops/library.py)."""
    _check_act(act)
    cuda_lib.dispatch_device(x, operand, shift)
    return torch.ops.ganreverser.dense_act(x, operand, shift, act)
