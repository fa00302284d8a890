"""Symmetric int8 with exact int32 sums: the int8 legs of G and R, the
counterpart of ganreverser_tpu/ops/quant.py (whose products XLA computes),
on kernels Q1-Q4 (``csrc/quant.cu``).

Scheme, as in the JAX package: weights int8 with one scale per output
channel (``s_w = max|w| / 127``), the eval BatchNorm folded in first;
activations int8 with one scale per tensor, computed on the device per call
(``quant_act``, kernel Q4); products summed in int32 (exact) and
dequantised as ``fma(float(acc), s_x * s_w[c], bias[c])``, one rounding:
what XLA's CPU fusion of ``y * s + b`` computes, emulated in f64 by the
plain versions; q is never -128, so the grid is symmetric and zero padding
stays exact.

* Q4 ``quantize_symmetric(x, axis=None)`` / ``quant_act``: per-tensor max,
  ``scale = max(m, 1e-12) / 127``, ``q = clip(round(x / scale), -127,
  127)`` (IEEE division, round half to even). The scale is a 0-dimensional
  f32 tensor on the device that Q1-Q3 read there: no ``.item()``. After
  an int8 producer, ``quant_act_max(y, amax)`` is Q4 in one pass: the
  producer, called ``with_max=True``, returned ``amax = max|y|`` of what
  it stored, taken in its epilogue, so y is read once.
* Q1 ``quant_conv3x3_same``: int8 SAME 3x3 conv, the epilogue, an optional
  activation and 2x2 max pool (R's layers; G's Co = 3 output conv).
* Q2 ``quant_upsample2_conv3x3``: kernel U's four 2x2 phase convs on int8
  operands, the 16 phase taps ``[a, ta, b, tb]`` quantised per output
  channel over all 16 taps x Ci (``quant_phase_weights``): the lhs-dilated
  int8 conv of the JAX ``make_fast_generator_xla_int8``.
* Q3 ``quant_dense``: (N, K) x (K, M) int8, the epilogue, an activation.

Each launches its kernel on CUDA tensors, through the custom ops of
``ops/library.py``, and takes its plain version (``*_plain``: int32 sums
from an exact f64 product, then the epilogue in JAX's order) on CPU
tensors; no other device is accepted. Weight quantisation per channel
(``axis`` given) is plain PyTorch, run once when a fast forward prepares
its weights. ``*_operand`` lays int8 weights out as the kernels read them:
Q1-Q3 on the int8 tensor cores (``csrc/conv_wgmma.cuh`` with s8 operands)
take them K-major, Q1 and Q2 ``(taps, Co, Ci')`` int8 with Ci' the padded
channels of ``conv_operands.padded_channels(Ci, 1)`` (32, 64 or a
multiple of 16), as the activations are padded (``pad_int8``), Q3 ``(M,
K')`` with K' padded the same way; ``OPERAND_LAYOUT`` names that layout,
which serving artifacts record (``io/serving.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import conv_operands, cuda_lib
from .topk_kernel import SMS
from .upsample_conv_kernel import phase_kernels

QMAX = 127.0
EPS = 1e-12
ACTS = ("none", "relu", "elu", "sigmoid")
QUANT_PARTS = 1024       # Q4's workspace of partial maxima (csrc/quant.cu)
DENSE_MAX_BN = 128       # Q3's widest column tile
DENSE_MIN_CHUNKS = 4     # K chunks a split of Q3 runs at least
# the layout of Q1's, Q2's and Q3's weight operands (conv_operand,
# phase_operand, dense_operand), recorded by int8 serving artifacts; one
# without it, or with "taps-co-ci-int8" (Q3 on words of four channels),
# bakes an older layout
OPERAND_LAYOUT = "taps-co-ci-int8+dense-m-k-int8"


# ----------------------------------------------------------------- plain

def _scale(m: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """max(m, eps) / 127 in IEEE division on any device, as Q4 and JAX
    compute it: on CUDA tensors PyTorch divides by a Python number as a
    multiply by its reciprocal, which is 1 ulp off for some m (182.19724
    gives 1.4346238 where the quotient is 1.4346240), so the divisor is a
    tensor."""
    return torch.clamp_min(m, eps) / torch.full_like(m, QMAX)


def quantize_plain(x: torch.Tensor, axis=None, eps: float = EPS):
    """(q int8, scale f32): ``scale`` the max |x| over ``axis`` (all of x
    for None, a 0-d tensor; else kept as size-1 dims) clamped at ``eps``,
    over 127 in IEEE division (:func:`_scale`: the activations' per-tensor
    scale and the weights' per-channel scales alike);
    ``q = clip(round(x / scale), -127, 127)``."""
    xf = x.float()
    a = xf.abs()
    scale = _scale(a.amax() if axis is None
                   else a.amax(dim=axis, keepdim=True), eps)
    q = torch.clamp(torch.round(xf / scale), -QMAX, QMAX)
    return q.to(torch.int8), scale


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "elu":  # jax.nn.elu: where(y > 0, y, expm1(y))
        return torch.where(y > 0, y, torch.expm1(torch.clamp_max(y, 0.0)))
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "none":
        return y
    raise ValueError(act)


def dequantize_plain(acc: torch.Tensor, x_scale: torch.Tensor,
                     w_scale: torch.Tensor, bias: torch.Tensor,
                     act: str = "none") -> torch.Tensor:
    """The kernels' epilogue on int32 sums ``acc`` (..., C): f32(acc) times
    the f32 product ``x_scale * w_scale[c]``, plus ``bias[c]``, rounded
    once to f32 (an f64 product of two f32 values is exact), then ``act``."""
    deq = (x_scale.float() * w_scale.float().reshape(-1)).double()
    y = acc.float().double() * deq + bias.float().double()
    return _act(y.float(), act)


def conv3x3_int32_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (N,H,W,Ci) * (3,3,Ci,Co) SAME conv, int32 sums (exact in f64:
    at most 127^2 * 9 * Ci)."""
    y = F.conv2d(xq.double().permute(0, 3, 1, 2),
                 wq.double().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def phase_conv_int32_plain(xq: torch.Tensor, wq16: torch.Tensor):
    """int8 (N,H,W,Ci) through the phase taps (2,2,2,2,Ci,Co) ``[a, ta, b,
    tb]``: output pixel (2i + a, 2j + b) sums input (i + a + ta - 1, j + b +
    tb - 1), zero outside. Returns (N,2H,2W,Co) int32."""
    n, h, w, _ = xq.shape
    co = wq16.shape[-1]
    xp = F.pad(xq.double(), (0, 0, 1, 1, 1, 1))
    out = torch.empty((n, h, 2, w, 2, co), dtype=torch.float64,
                      device=xq.device)
    for a in (0, 1):
        for b in (0, 1):
            wt = wq16[a, :, b].double().permute(3, 2, 0, 1)
            y = F.conv2d(xp[:, a:a + h + 1, b:b + w + 1].permute(0, 3, 1, 2),
                         wt)
            out[:, :, a, :, b] = y.permute(0, 2, 3, 1)
    return out.reshape(n, 2 * h, 2 * w, co).to(torch.int32)


def s8_sums_plain(xq: torch.Tensor, operand: torch.Tensor, bk: int,
                  phases: bool = False) -> torch.Tensor:
    """Q1's (``phases`` False) or Q2's s32 sums in the tensor-core tile's K
    order, on any device, from the operands the kernel reads: ``xq``
    padded by :func:`pad_int8` and ``operand`` (:func:`conv_operand`'s (9,
    Co, Ci') or :func:`phase_operand`'s (16, Co, Ci')); each tap, then
    each ``bk``-channel chunk, exact in f64
    (``conv_operands.implicit_gemm_plain``). Returns (N,H,W,Co) or, with
    ``phases``, (N,2H,2W,Co) int32."""
    xk = pad_int8(xq)

    def sums(taps):
        return conv_operands.implicit_gemm_plain(
            xk, operand, taps, bk, torch.float64).to(torch.int32)
    if not phases:
        return sums(conv_operands.CONV3X3_TAPS)
    n, h, w, _ = xk.shape
    out = torch.empty((n, h, 2, w, 2, operand.shape[1]), dtype=torch.int32,
                      device=xq.device)
    for a in (0, 1):
        for b in (0, 1):
            out[:, :, a, :, b] = sums(conv_operands.phase_taps(a, b))
    return out.reshape(n, 2 * h, 2 * w, -1)


def dense_int32_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(N,K) int8 x (K,M) int8, int32 sums (exact in f64)."""
    return (xq.double() @ wq.double()).to(torch.int32)


def quantize_with_max_plain(x: torch.Tensor, amax: torch.Tensor):
    """Plain version of Q4's one pass: :func:`quantize_plain`'s (q, scale)
    of ``x`` from its max ``amax`` = max |x| given (0-d f32): bitwise
    ``quantize_plain(x)`` where ``amax`` is that max."""
    scale = _scale(amax.float())
    q = torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX)
    return q.to(torch.int8), scale


def _with_max(y: torch.Tensor, with_max: bool):
    """A producer's plain result: ``y``, or ``(y, max |y|)`` (0-d) of
    exactly that ``y``."""
    return (y, y.abs().amax()) if with_max else y


def _pool2(y: torch.Tensor) -> torch.Tensor:
    n, h, w, c = y.shape
    return y.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def quant_conv3x3_plain(xq, x_scale, wq, w_scale, bias, *, act="none",
                        pool=False, with_max=False):
    """Plain version of Q1 on any device; ``with_max``: also max |y|."""
    y = dequantize_plain(conv3x3_int32_plain(xq, wq), x_scale, w_scale, bias,
                         act)
    return _with_max(_pool2(y) if pool else y, with_max)


def quant_upsample2_conv3x3_plain(xq, x_scale, wq16, w_scale, shift, *,
                                  act="relu", with_max=False):
    """Plain version of Q2 on any device; ``with_max``: also max |y|."""
    return _with_max(dequantize_plain(phase_conv_int32_plain(xq, wq16),
                                      x_scale, w_scale, shift, act), with_max)


def quant_dense_plain(xq, x_scale, wq, w_scale, bias, *, act="none",
                      with_max=False):
    """Plain version of Q3 on any device; ``with_max``: also max |y|."""
    return _with_max(dequantize_plain(dense_int32_plain(xq, wq), x_scale,
                                      w_scale, bias, act), with_max)


# ------------------------------------------------------ weight layouts

def fold_quantize_conv(kernel: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor):
    """Fold an eval BatchNorm's (scale, shift) (``conv_kernel.
    fold_batchnorm``) into a (3,3,Ci,Co) HWIO kernel, then quantise per
    output channel. Returns (wq int8 HWIO, w_scale (1,1,1,Co), bias f32
    (Co,))."""
    w = kernel.float() * scale.float().reshape(1, 1, 1, -1)
    wq, w_scale = quantize_plain(w, axis=(0, 1, 2))
    return wq, w_scale, shift.float()


def fold_quantize_dense(kernel: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor):
    """The same for a dense (K, M) kernel with per-column scales. Returns
    (wq int8, w_scale (1, M), bias f32 (M,))."""
    w = kernel.float() * scale.float().reshape(1, -1)
    wq, w_scale = quantize_plain(w, axis=(0,))
    return wq, w_scale.reshape(1, -1), shift.float()


def quant_phase_weights(kernel: torch.Tensor, scale: torch.Tensor):
    """G's upsample stage in int8: the (3,3,Ci,Co) kernel times the folded
    BatchNorm scale, aggregated in f32 into the 16 phase taps (kernel U's
    ``phase_kernels``, bitwise the JAX package's 4x4 lhs-dilated kernel:
    tap [a, ta, b, tb] is its [2 ta + a, 2 tb + b]), quantised per output
    channel over all 16 taps x Ci. Returns (wq16 (2,2,2,2,Ci,Co) int8,
    w_scale (Co,))."""
    w = kernel.float() * scale.float().reshape(1, 1, 1, -1)
    wq16, w_scale = quantize_plain(phase_kernels(w),
                                   axis=(0, 1, 2, 3, 4))
    return wq16, w_scale.reshape(-1)


def conv_operand(wq: torch.Tensor) -> torch.Tensor:
    """A (3,3,Ci,Co) int8 kernel as Q1 reads it: (9, Co, Ci') int8,
    K-major, tap t = (t // 3, t % 3), Ci' = ``padded_channels(Ci, 1)``,
    the padding zero."""
    return conv_operands.kmajor(wq.reshape(9, *wq.shape[2:]), torch.int8, 1)


def phase_operand(wq16: torch.Tensor) -> torch.Tensor:
    """The (2,2,2,2,Ci,Co) int8 phase taps as Q2 reads them: (16, Co,
    Ci') int8, K-major, tap [a, ta, b, tb] at ((a * 2 + ta) * 2 + b) * 2 +
    tb, the padding zero."""
    return conv_operands.kmajor(wq16.reshape(16, *wq16.shape[4:]),
                                torch.int8, 1)


def dense_operand(wq: torch.Tensor) -> torch.Tensor:
    """A (K, M) int8 kernel as Q3 reads it: (M, K') int8, K-major, K' =
    ``padded_channels(K, 1)``, the padding zero."""
    return conv_operands.kmajor(wq[None], torch.int8, 1)[0]


def pad_int8(xq: torch.Tensor) -> torch.Tensor:
    """int8 NHWC ``xq`` with its channels zero-padded as Q1 and Q2 read
    them (``padded_channels(C, 1)``: R's 3-channel stem to 32, a copy of
    33.6 MB at batch 256 and 64 x 64), contiguous. Zero channels add exact
    zeros to the s32 sums."""
    return conv_operands.pad_channels(xq, 1)


def dense_splits(tiles: int, chunks: int) -> int:
    """Q3's K splits over ``chunks`` stages of K and ``tiles`` (N, M)
    tiles: where the tiles alone leave SMs idle, the most splits, a divisor
    of ``chunks`` (each split runs the same count), that keep the blocks
    within one per SM and give each split at least ``DENSE_MIN_CHUNKS``
    stages; 1 otherwise. R l27 (8 tiles, 256 chunks): 16 splits of 16."""
    want = SMS // tiles
    return max((d for d in range(1, chunks + 1)
                if chunks % d == 0 and d <= want
                and chunks // d >= DENSE_MIN_CHUNKS), default=1)


class DensePolicy(NamedTuple):
    """What sets one dense kernel's plan apart from another's (Q3 here,
    kernel D in ops/dense_kernel.py); the rest of :func:`dense_plan` is
    theirs in common."""
    elem_bytes: int     # bytes of an operand element: 1 int8, 2 bf16
    max_bn: int         # the widest column tile
    split_chunks: int   # K of at least this many stages is split where
    #                     the tiles leave SMs idle; a shorter K narrows BN
    out_bytes: int      # bytes of a value of the unsplit epilogue's tile
    deep_ring: bool     # a grid of at most one block an SM takes a ring
    #                     of all the shared memory, not RING_BYTES[BN]


# Q3: BN up to 128, f32 outputs, split from 8 stages of K
Q3_POLICY = DensePolicy(1, DENSE_MAX_BN, 2 * DENSE_MIN_CHUNKS, 4, False)


def dense_plan(n: int, k: int, m: int, policy: DensePolicy = Q3_POLICY):
    """A dense kernel's launch as (TilePlan, splits): :func:`dense_plan_at`'s
    at BN the least width covering M up to ``policy.max_bn``, halved (down
    to 16) while the (N, M) tiles leave SMs idle and K is shorter than
    ``policy.split_chunks`` stages: more blocks in flight where the tiles
    are few and short (R l31), K splits where K is long (R l27).
    ``tools/dense_plans.py`` times each BN of Q3 on the card (PERF.md
    section 6)."""
    co = conv_operands
    kp = co.padded_channels(k, policy.elem_bytes)
    bk = kp if kp <= 64 // policy.elem_bytes else 128 // policy.elem_bytes
    bn = next(b for b in co.WIDTHS_N if min(m, policy.max_bn) <= b)
    rows = -(-n // co.BM)
    if -(-kp // bk) < policy.split_chunks:
        while bn > co.WIDTHS_N[0] and rows * -(-m // bn) < SMS:
            bn //= 2
    return dense_plan_at(n, k, m, bn, policy)


def dense_plan_at(n: int, k: int, m: int, bn: int,
                  policy: DensePolicy = Q3_POLICY):
    """A dense kernel's (TilePlan, splits) at column tile width ``bn``: the
    tile is 1 x 128 rows of x (``DenseTaps``: one tap of a 1 x N image),
    BK the padded K's depth up to a 128-byte row, K of at least
    ``policy.split_chunks`` stages split by :func:`dense_splits`; the ring
    as :func:`conv_operands.tile_plan`'s (or, with ``policy.deep_ring``
    and a grid of at most one block an SM, as many stages as the shared
    memory holds), no deeper than a split's stages, holding the staged
    tile (a split's f32 sums, else values of ``policy.out_bytes``)."""
    co = conv_operands
    kp = co.padded_channels(k, policy.elem_bytes)
    bk = kp if kp <= 64 // policy.elem_bytes else 128 // policy.elem_bytes
    chunks = -(-kp // bk)
    tiles = -(-n // co.BM) * -(-m // bn)
    splits = (dense_splits(tiles, chunks)
              if chunks >= policy.split_chunks else 1)
    stage = -(-(co.BM + bn) * bk * policy.elem_bytes // co.ALIGN) * co.ALIGN
    staged = co.staged_bytes(bn, 4 if splits > 1 else policy.out_bytes)
    ring = (co.MAX_SHARED_BYTES - co.ALIGN
            if policy.deep_ring and tiles * splits <= SMS
            else co.RING_BYTES[bn])
    stages = max(2, min(co.MAX_STAGES, ring // stage, chunks // splits),
                 -(-staged // stage))
    return (co.TilePlan(1, co.BM, bn, bk, stages,
                        co.ALIGN + stages * (stage + 16)), splits)


def dense_k_ranges(k: int, plan, splits: int) -> list:
    """The [k0, k1) of K' each of Q3's splits adds (``DenseTaps``: split z
    runs chunks z * c .. (z + 1) * c - 1 of ``plan.bk``, c = chunks /
    splits), clipped to K' = ``padded_channels(k, 1)``."""
    kp = conv_operands.padded_channels(k, 1)
    per = -(-kp // plan.bk) // splits * plan.bk
    return [(z * per, min(kp, (z + 1) * per)) for z in range(splits)]


def dense_sums_plain(xq: torch.Tensor, operand: torch.Tensor, plan,
                     splits: int) -> torch.Tensor:
    """Q3's s32 sums as the kernel takes them, on any device: each split's
    K range (:func:`dense_k_ranges`) of the padded ``xq`` against
    :func:`dense_operand`'s (M, K'), exact in f64, then the splits added
    in order. Returns (N, M) int32."""
    xk = conv_operands.pad_channels(xq, 1).double()
    w = operand.double()
    acc = torch.zeros((xq.shape[0], operand.shape[0]), dtype=torch.int32,
                      device=xq.device)
    for k0, k1 in dense_k_ranges(xq.shape[1], plan, splits):
        acc += (xk[:, k0:k1] @ w[:, k0:k1].T).to(torch.int32)
    return acc


def _flat_scale(t: torch.Tensor, n: int, device, name: str):
    t = t.float().reshape(-1).contiguous()
    cuda_lib.require(t, name, device, torch.float32, (n,))
    return t


# ------------------------------------------------- the kernels' launches

def launch_quantize_act(x: torch.Tensor):
    """Q4 on CUDA, its plain version on the CPU: the body of the
    ``ganreverser::quantize_act`` op."""
    if cuda_lib.dispatch_device(x) == "cpu":
        return quantize_plain(x)
    xf = x.float().contiguous()
    q = torch.empty(xf.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    parts = torch.empty(QUANT_PARTS, dtype=torch.float32, device=x.device)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_quantize_act(
            xf.data_ptr(), q.data_ptr(), scale.data_ptr(), parts.data_ptr(),
            xf.numel(), cuda_lib.stream_of(x))
    cuda_lib.check(rc, "quantize_act")
    quant_act.launches += 1
    return q, scale


def launch_quantize_act_max(x: torch.Tensor, amax: torch.Tensor):
    """Q4's one pass on CUDA, its plain version on the CPU: the body of the
    ``ganreverser::quantize_act_max`` op."""
    if cuda_lib.dispatch_device(x, amax) == "cpu":
        return quantize_with_max_plain(x, amax)
    xf = x.float().contiguous()
    cuda_lib.require(amax, "amax", x.device, torch.float32, ())
    q = torch.empty(xf.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_quantize_act_max(
            xf.data_ptr(), amax.data_ptr(), q.data_ptr(), scale.data_ptr(),
            xf.numel(), cuda_lib.stream_of(x))
    cuda_lib.check(rc, "quantize_act_max")
    quant_act_max.launches += 1
    return q, scale


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def _op_outputs(y: torch.Tensor, with_max: bool):
    """A producer op's two outputs from its plain version's ``y``: y and
    max |y| (0-d), or an empty (0,) f32 where the max was not asked."""
    return y, (y.abs().amax() if with_max else y.new_empty((0,)))


def _max_out(with_max: bool, like: torch.Tensor):
    """(the 0-d f32 output the kernel raises to max |y|, its pointer), or
    (an empty (0,) f32, None): the C entry point zeroes the word."""
    t = torch.empty(() if with_max else (0,), dtype=torch.float32,
                    device=like.device)
    return t, (t.data_ptr() if with_max else None)


def launch_quant_conv3x3(xq, x_scale, wq, w_scale, bias, act, pool,
                         with_max, operand):
    """Q1 on CUDA, its plain version on the CPU: the body of the
    ``ganreverser::quant_conv3x3`` op; returns (y, max |y| or empty)."""
    _check_act(act)
    if cuda_lib.dispatch_device(xq, x_scale, wq, w_scale, bias) == "cpu":
        return _op_outputs(quant_conv3x3_plain(
            xq, x_scale, wq, w_scale, bias, act=act, pool=pool), with_max)
    n, h, w, ci = xq.shape
    co = wq.shape[-1]
    if tuple(wq.shape[:3]) != (3, 3, ci):
        raise ValueError(f"quant_conv3x3: kernel {tuple(wq.shape)} does not "
                         f"take the input's {ci} channels")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"pool needs even H and W, got {h}x{w}")
    xk = pad_int8(xq)
    cp = xk.shape[-1]
    plan = conv_operands.tile_plan(h, w, ci, co, out_bytes=4, elem_bytes=1)
    wk = conv_operand(wq) if operand is None else operand
    cuda_lib.require(xk, "xq", xq.device, torch.int8, (n, h, w, cp))
    cuda_lib.require(wk, "kernel", xq.device, torch.int8, (9, co, cp))
    xs = _flat_scale(x_scale, 1, xq.device, "x_scale")
    ws = _flat_scale(w_scale, co, xq.device, "w_scale")
    b = _flat_scale(bias, co, xq.device, "bias")
    oh, ow = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((n, oh, ow, co), dtype=torch.float32, device=xq.device)
    amax, amax_ptr = _max_out(with_max, xq)
    with cuda_lib.on_device(xq):
        rc = cuda_lib.library().gr_quant_conv3x3(
            xk.data_ptr(), wk.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            b.data_ptr(), out.data_ptr(), amax_ptr, n, h, w, cp, co,
            cuda_lib.ACT_CODES[act], int(pool), *plan,
            cuda_lib.stream_of(xq))
    cuda_lib.check(rc, "quant_conv3x3")
    quant_conv3x3_same.launches += 1
    return out, amax


def launch_quant_upsample2_conv3x3(xq, x_scale, wq16, w_scale, shift, act,
                                   with_max, operand):
    """Q2 on CUDA, its plain version on the CPU: the body of the
    ``ganreverser::quant_upsample2_conv3x3`` op; returns (y, max |y| or
    empty)."""
    _check_act(act)
    if cuda_lib.dispatch_device(xq, x_scale, wq16, w_scale, shift) == "cpu":
        return _op_outputs(quant_upsample2_conv3x3_plain(
            xq, x_scale, wq16, w_scale, shift, act=act), with_max)
    n, h, w, ci = xq.shape
    co = wq16.shape[-1]
    if tuple(wq16.shape[:5]) != (2, 2, 2, 2, ci):
        raise ValueError(f"quant_upsample2_conv3x3: phase taps "
                         f"{tuple(wq16.shape)} do not take the input's {ci} "
                         "channels")
    xk = pad_int8(xq)
    cp = xk.shape[-1]
    plan = conv_operands.tile_plan(h, w, ci, co, out_bytes=4, elem_bytes=1)
    wk = phase_operand(wq16) if operand is None else operand
    cuda_lib.require(xk, "xq", xq.device, torch.int8, (n, h, w, cp))
    cuda_lib.require(wk, "kernel", xq.device, torch.int8, (16, co, cp))
    xs = _flat_scale(x_scale, 1, xq.device, "x_scale")
    ws = _flat_scale(w_scale, co, xq.device, "w_scale")
    b = _flat_scale(shift, co, xq.device, "shift")
    out = torch.empty((n, 2 * h, 2 * w, co), dtype=torch.float32,
                      device=xq.device)
    amax, amax_ptr = _max_out(with_max, xq)
    with cuda_lib.on_device(xq):
        rc = cuda_lib.library().gr_quant_upsample2_conv3x3(
            xk.data_ptr(), wk.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            b.data_ptr(), out.data_ptr(), amax_ptr, n, h, w, cp, co,
            cuda_lib.ACT_CODES[act], *plan, cuda_lib.stream_of(xq))
    cuda_lib.check(rc, "quant_upsample2_conv3x3")
    quant_upsample2_conv3x3.launches += 1
    return out, amax


def launch_quant_dense(xq, x_scale, wq, w_scale, bias, act, with_max,
                       operand):
    """Q3 on CUDA, its plain version on the CPU: the body of the
    ``ganreverser::quant_dense`` op; returns (y, max |y| or empty)."""
    _check_act(act)
    if cuda_lib.dispatch_device(xq, x_scale, wq, w_scale, bias) == "cpu":
        return _op_outputs(quant_dense_plain(
            xq, x_scale, wq, w_scale, bias, act=act), with_max)
    n, k = xq.shape
    m = wq.shape[-1]
    if wq.shape[0] != k:
        raise ValueError(f"quant_dense: kernel {tuple(wq.shape)} does not "
                         f"take the input's {k} features")
    xk = conv_operands.pad_channels(xq, 1)
    kp = xk.shape[-1]
    wk = dense_operand(wq) if operand is None else operand
    cuda_lib.require(xk, "xq", xq.device, torch.int8, (n, kp))
    cuda_lib.require(wk, "kernel", xq.device, torch.int8, (m, kp))
    xs = _flat_scale(x_scale, 1, xq.device, "x_scale")
    ws = _flat_scale(w_scale, m, xq.device, "w_scale")
    b = _flat_scale(bias, m, xq.device, "bias")
    plan, splits = dense_plan(n, k, m)
    part = (torch.empty((splits, n, m), dtype=torch.int32, device=xq.device)
            if splits > 1 else None)
    out = torch.empty((n, m), dtype=torch.float32, device=xq.device)
    amax, amax_ptr = _max_out(with_max, xq)
    with cuda_lib.on_device(xq):
        rc = cuda_lib.library().gr_quant_dense(
            xk.data_ptr(), wk.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            b.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), amax_ptr, n, kp, m,
            cuda_lib.ACT_CODES[act], splits, *plan, cuda_lib.stream_of(xq))
    cuda_lib.check(rc, "quant_dense")
    quant_dense.launches += 1
    return out, amax


# ---------------------------------------------- the JAX package's API

def quantize_symmetric(x: torch.Tensor, axis=None):
    """(q int8, scale): x ~= q * scale, q in [-127, 127], the scale's max
    clamped at 1e-12 (JAX's default ``eps``). ``axis`` None: one per-tensor
    scale (shape ()), kernel Q4 on a CUDA tensor; otherwise the axes to
    reduce over, leaving per-slice scales (the weights' case, quantised
    once when a fast forward prepares them, plain PyTorch on any
    device)."""
    if axis is None:
        return quant_act(x)
    return quantize_plain(x, axis)


@cuda_lib.counted
def quant_act(x: torch.Tensor):
    """Dynamic per-tensor activation quantisation (Q4): (q int8 of
    ``x``'s shape, scale 0-d f32)."""
    cuda_lib.dispatch_device(x)
    return torch.ops.ganreverser.quantize_act(x)


@cuda_lib.counted
def quant_act_max(x: torch.Tensor, amax: torch.Tensor):
    """Q4 in one pass after an int8 producer: :func:`quant_act`'s (q,
    scale) of ``x`` from ``amax`` = max |x|, the 0-d f32 the producer
    returned with ``with_max=True``; one read of x."""
    cuda_lib.dispatch_device(x, amax)
    return torch.ops.ganreverser.quantize_act_max(x, amax)


def _maybe_max(result, with_max: bool):
    return result if with_max else result[0]


@cuda_lib.counted
def quant_conv3x3_same(xq: torch.Tensor, x_scale: torch.Tensor,
                       wq: torch.Tensor, w_scale: torch.Tensor,
                       bias: torch.Tensor, *, act: str = "none",
                       pool: bool = False,
                       operand: torch.Tensor | None = None,
                       with_max: bool = False):
    """Q1: ``conv(xq, wq) * (x_scale * w_scale) + bias`` (one rounding), then
    ``act`` and with ``pool`` the 2x2 max pool; f32 (N,H,W,Co), or
    (N,H/2,W/2,Co). xq (N,H,W,Ci) int8, x_scale 0-d; wq (3,3,Ci,Co) int8,
    w_scale (1,1,1,Co) (or (Co,)), bias (Co,). ``operand``: ``wq`` laid
    out beforehand by :func:`conv_operand`. ``with_max``: returns (y,
    max |y|), the max taken in the kernel's epilogue, for
    :func:`quant_act_max`."""
    _check_act(act)
    cuda_lib.dispatch_device(xq, x_scale, wq, w_scale, bias)
    return _maybe_max(torch.ops.ganreverser.quant_conv3x3(
        xq, x_scale, wq, w_scale, bias, act, pool, with_max, operand),
        with_max)


@cuda_lib.counted
def quant_upsample2_conv3x3(xq: torch.Tensor, x_scale: torch.Tensor,
                            wq16: torch.Tensor, w_scale: torch.Tensor,
                            shift: torch.Tensor, *, act: str = "relu",
                            operand: torch.Tensor | None = None,
                            with_max: bool = False):
    """Q2: nearest-upsample x2 + 3x3 conv as kernel U's four phase convs on
    int8 operands (:func:`quant_phase_weights`), dequantised with
    ``x_scale * w_scale[c]`` + ``shift``, then ``act``. xq (N,H,W,Ci)
    int8; returns (N,2H,2W,Co) f32, with ``with_max`` (y, max |y|).
    ``operand``: ``wq16`` laid out beforehand by :func:`phase_operand`."""
    _check_act(act)
    cuda_lib.dispatch_device(xq, x_scale, wq16, w_scale, shift)
    return _maybe_max(torch.ops.ganreverser.quant_upsample2_conv3x3(
        xq, x_scale, wq16, w_scale, shift, act, with_max, operand), with_max)


@cuda_lib.counted
def quant_dense(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor,
                w_scale: torch.Tensor, bias: torch.Tensor, *,
                act: str = "none", operand: torch.Tensor | None = None,
                with_max: bool = False):
    """Q3: ``(xq @ wq) * (x_scale * w_scale) + bias`` (one rounding), then
    ``act``. xq (N,K) int8; wq (K,M) int8, w_scale (1,M) (or (M,)), bias
    (M,). Returns (N,M) f32, with ``with_max`` (y, max |y|). ``operand``:
    ``wq`` laid out beforehand by :func:`dense_operand`."""
    _check_act(act)
    cuda_lib.dispatch_device(xq, x_scale, wq, w_scale, bias)
    return _maybe_max(torch.ops.ganreverser.quant_dense(
        xq, x_scale, wq, w_scale, bias, act, with_max, operand), with_max)
