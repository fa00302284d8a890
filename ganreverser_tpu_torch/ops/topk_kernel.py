"""Kernel C: fused row-normalisation + cosine-score product.

The counterpart of ganreverser_tpu/ops/topk_kernel.py: scores[q, n] =
<e[needle_q], e[n]> / (|e[needle_q]| |e[n]|), with both norms computed in
the same pass over D as the dot products (``csrc/cosine_scores.cu``). The
squared norms are clamped at 1e-16, the TPU kernel's clamp, which differs
from analysis/similarity.py's clamp of the norm at 1e-8 only on degenerate
rows. Any D and any N are taken. Top-k is ``torch.topk`` outside
(analysis/similarity.py).

In bf16 the kernel streams E once through TMA and takes the products on the
tensor cores, with D split into slices across blocks (``cosine_plan``), so
it runs in two launches: per-slice partial dots and sums of squares
(:func:`cosine_partials_plain`), then their sums in slice order and the
clamp (:func:`cosine_finish_plain`). TMA reads rows of a multiple of 16
bytes, so where D % 8 != 0 the wrapper zero-pads E's rows to a multiple of
8 first (a copy of E: 2 MB for apply_r's 10,000 latents of 100; the pixel
search's D = 12,288 needs none). In f32 one launch on the CUDA cores loops
over D and masks the ragged end of N, padding nothing.

``cosine_scores`` (a custom operator of ops/library.py) launches the kernel
on CUDA tensors and takes the plain version ``cosine_scores_plain`` on CPU
tensors; no other device is accepted.
``cosine_scores.launches`` counts the calls that launched it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .conv_operands import ALIGN, MAX_STAGES, RING_BYTES, WIDTHS_N

_EPS = 1e-8
BM = 128      # rows of E per block
BK = 64       # elements of D per stage (one 128-byte swizzled row)
SMS = 132     # streaming multiprocessors of an H100 SXM
# the most BK chunks one slice adds up in the tensor cores' accumulators:
# their f32 sums lose more than IEEE f32 sums over a long D (on an NVIDIA
# H100, one slice of D = 12,288 at 256 needles put the scores 2.5e-5 to
# 4.2e-5 from an f64 reference, three of 64 chunks 5.9e-6 to 7.6e-6, at
# the same device time)
MAX_SLICE_CHUNKS = 64


class CosinePlan(NamedTuple):
    dp: int          # D as the kernel reads it: a multiple of 8
    bnq: int         # needles per block: a width >= Q the kernel is built for
    tiles: int       # grid x: blocks of BM rows over N
    groups: int      # grid y: groups of bnq needles over Q
    slices: int      # grid z: D split into slices of whole BK chunks
    stages: int      # stages of the TMA ring
    smem_bytes: int  # the block's dynamic shared memory


def cosine_plan(n: int, d: int, q: int) -> CosinePlan:
    """The bf16 kernel's launch at N rows of D and Q needles. D is padded
    to a multiple of 8 (16-byte rows for TMA). BNQ is the least width the
    kernel is built for that holds Q, at most 256; more needles loop over
    grid y. The ring takes ``RING_BYTES[BNQ]`` (three blocks an SM up to
    BNQ = 64). D is split into as many slices as fill one wave of resident
    blocks on the card's SMS SMs with the N tiles and needle groups, and
    at least as many as keep a slice within MAX_SLICE_CHUNKS chunks (the
    slices are added in f32 by the second launch), at most one slice per
    BK chunk."""
    dp = -(-d // 8) * 8
    bnq = next((b for b in WIDTHS_N if q <= b), WIDTHS_N[-1])
    tiles, groups = -(-n // BM), -(-q // bnq)
    chunks = -(-dp // BK)
    stage = -(-(BM * BK * 2 + bnq * BK * 2) // ALIGN) * ALIGN
    stages = max(2, min(MAX_STAGES, RING_BYTES[bnq] // stage))
    per_sm = 3 if bnq <= 64 else 1
    slices = max(1, -(-chunks // MAX_SLICE_CHUNKS),
                 min(chunks, SMS * per_sm // (tiles * groups)))
    return CosinePlan(dp, bnq, tiles, groups, slices, stages,
                      ALIGN + stages * (stage + 16))


def slice_bounds(d: int, slices: int) -> list:
    """[(d0, d1)] of each slice over D: slice s takes BK chunks
    [s * C // S, (s + 1) * C // S) of the C = ceil(D / BK), clipped at D."""
    chunks = -(-d // BK)
    return [(s * chunks // slices * BK,
             min(d, (s + 1) * chunks // slices * BK)) for s in range(slices)]


def workspace_floats(plan: CosinePlan, q: int, n: int) -> int:
    """f32 elements of the partials: (S, Q, N) dots, then (S, N) sums of
    squares."""
    return plan.slices * (q * n + n)


def cosine_scores_plain(embeddings: torch.Tensor,
                        needle_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: (Q, N) f32."""
    e = embeddings.float()
    q = e.index_select(0, needle_idx)
    qn = q * torch.rsqrt(torch.clamp_min((q * q).sum(1, keepdim=True),
                                         _EPS * _EPS))
    en = e * torch.rsqrt(torch.clamp_min((e * e).sum(1, keepdim=True),
                                         _EPS * _EPS))
    return qn @ en.T


def cosine_partials_plain(embeddings: torch.Tensor, needle_idx: torch.Tensor,
                          slices: int):
    """The bf16 kernel's first launch in plain PyTorch on any device: per
    slice of D (``slice_bounds``), the needles' dots with every row and
    every row's sum of squares, f32. Returns ((S, Q, N), (S, N))."""
    e = embeddings.float()
    q = e.index_select(0, needle_idx)
    bounds = slice_bounds(e.shape[1], slices)
    part_dot = torch.stack([q[:, a:b] @ e[:, a:b].T for a, b in bounds])
    part_sq = torch.stack([(e[:, a:b] * e[:, a:b]).sum(1) for a, b in bounds])
    return part_dot, part_sq


def cosine_finish_plain(part_dot: torch.Tensor, part_sq: torch.Tensor,
                        needle_idx: torch.Tensor) -> torch.Tensor:
    """The second launch: the slices added in slice order, a needle's
    squared norm its own row's, then the clamped quotient. (Q, N) f32."""
    dot, ee = part_dot[0], part_sq[0]
    for s in range(1, part_dot.shape[0]):
        dot = dot + part_dot[s]
        ee = ee + part_sq[s]
    qq = ee.index_select(0, needle_idx)
    return dot / (torch.sqrt(torch.clamp_min(qq, _EPS * _EPS))[:, None]
                  * torch.sqrt(torch.clamp_min(ee, _EPS * _EPS))[None, :])


def padded_corpus(embeddings: torch.Tensor) -> torch.Tensor:
    """``embeddings`` as :func:`cosine_scores` hands them to the kernel:
    a bf16 tensor on the card with its rows zero-padded to a multiple of 8
    (the zero columns add exact zeros to every sum, and the launch plan of
    the padded D is the unpadded one's, so the scores are bitwise the
    same); any other tensor as it is."""
    d = embeddings.shape[1]
    if (embeddings.device.type != "cuda"
            or embeddings.dtype != torch.bfloat16 or d % 8 == 0):
        return embeddings
    return F.pad(embeddings, (0, -(-d // 8) * 8 - d))


def cosine_scores(embeddings: torch.Tensor,
                  needle_idx: torch.Tensor) -> torch.Tensor:
    """embeddings: (N, D) f32 or bf16; needle_idx: (Q,) int64 row indices.
    Returns (Q, N) f32 cosine scores. Runs as the custom operator
    ``ganreverser::cosine_scores`` (ops/library.py)."""
    cuda_lib.dispatch_device(embeddings)
    return torch.ops.ganreverser.cosine_scores(
        embeddings, needle_idx.to(device=embeddings.device, dtype=torch.int64))


def launch_cosine_scores(embeddings: torch.Tensor,
                         needle_idx: torch.Tensor) -> torch.Tensor:
    """The body of ``ganreverser::cosine_scores``: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if cuda_lib.dispatch_device(embeddings, needle_idx) == "cpu":
        return cosine_scores_plain(embeddings, needle_idx)
    code = cuda_lib.dtype_code(embeddings)
    n, d = embeddings.shape
    q = needle_idx.shape[0]
    e = embeddings.contiguous()
    if embeddings.dtype == torch.bfloat16:
        plan = cosine_plan(n, d, q)
        if plan.dp != d:  # TMA reads rows of a multiple of 16 bytes
            e = F.pad(e, (0, plan.dp - d))
        ws = torch.empty(workspace_floats(plan, q, n), dtype=torch.float32,
                         device=e.device)
        launch_plan = (plan.bnq, plan.slices, plan.stages, plan.smem_bytes)
    else:
        ws, launch_plan = None, (0, 0, 0, 0)
    needles = e.index_select(0, needle_idx).contiguous()
    needle_idx = needle_idx.contiguous()
    cuda_lib.require(e, "embeddings", embeddings.device, embeddings.dtype,
                     (n, e.shape[1]))
    cuda_lib.require(needles, "needles", embeddings.device, embeddings.dtype,
                     (q, e.shape[1]))
    out = torch.empty((q, n), dtype=torch.float32, device=embeddings.device)
    with cuda_lib.on_device(embeddings):
        rc = cuda_lib.library().gr_cosine_scores(
            code, needles.data_ptr(), e.data_ptr(), needle_idx.data_ptr(),
            None if ws is None else ws.data_ptr(), out.data_ptr(), q, n,
            e.shape[1], *launch_plan, cuda_lib.stream_of(embeddings))
    cuda_lib.check(rc, "cosine_scores")
    cosine_scores.launches += 1
    return out


cuda_lib.counted(cosine_scores)
