"""Kernel S: approximate top-k selection at a recall target.

The counterpart of ``jax.lax.approx_max_k`` as ganreverser_tpu/analysis/
similarity.py:34-52 (``_select_topk``) calls it, with the candidates ranked
within themselves (``aggregate_to_topk``). XLA's bins on the TPU are its
own and cannot be reproduced, so the port fixes its rule, and the kernel
(``csrc/approx_topk.cu``) and the plain version here compute exactly it:

1. element j of a row goes to bin ``j mod L``;
2. each bin keeps its largest value, a tie going to the lower j;
3. the L candidates are ranked by value, descending, a tie going to the
   lower j;
4. the first k are returned: values (Q, k) f32 and indices (Q, k) int64.

Ranking by (value, then lower j) is ranking by one 64-bit key per element,
an order-preserving map of the value's bits above ``0xFFFFFFFF - j``
(:func:`order_keys`): every key is distinct, so the bins' maxima and the
ranking have no ties left, and the kernel and the plain version agree
bitwise. -0.0 ranks as +0.0; a NaN ranks by its bits (a positive NaN above
+inf, as ``torch.topk`` has it).

The i-th best element survives when none of the i - 1 better ones shares
its bin: probability (1 - 1/L)^(i-1), which averages about
1 - (k - 1) / (2 L) over the first k. :func:`approx_plan` takes the least
power of two L that reaches the recall target by that estimate, at least
k and at most N; at L = N every bin holds one element and the selection is
exact, as it is for ``recall_target = 1``.

The kernel selects instead of sorting, in one launch for every L
(:func:`select_plan`): a radix walk over the bins' keys finds the k-th
largest, and only the k keys at or above it are sorted. A row is a
thread-block cluster of 1-8 blocks, more than one where few rows would
leave the card's SMs idle; the keys stay in the blocks' shared memory
where they fit, otherwise each pass walks the row again; where bins hold
several elements the row is first staged in shared memory. ``approx_topk``
(the custom operator ``ganreverser::approx_topk`` of ops/library.py)
launches it on CUDA tensors and runs ``approx_topk_plain`` on CPU
tensors; no other device is accepted. ``approx_topk.launches`` counts the
calls that launched it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import cuda_lib
from .topk_kernel import SMS

KEY_BYTES = 8
SMEM_LIMIT = 232_448     # dynamic + static shared memory a block may take
SMEM_FIXED = 4096        # the kernel's static histograms and control words
MAX_CLUSTER = 8          # blocks of a row's cluster (the portable limit)
MIN_CLUSTER_BINS = 1024  # bins each block of a cluster owns at least
_LOW = 0xFFFFFFFF


def approx_plan(n: int, k: int, recall_target: float) -> int:
    """The bin count L for top-``k`` of ``n`` at ``recall_target``: the
    least power of two >= k with 1 - (k - 1) / (2 L) >= recall_target,
    capped at n (``recall_target = 1`` gives n: the exact selection)."""
    if not 0 < recall_target <= 1:
        raise ValueError(f"recall_target must lie in (0, 1], got "
                         f"{recall_target}")
    if not 1 <= k <= n:
        raise ValueError(f"k must lie in 1..{n}, got {k}")
    if recall_target == 1:
        return n
    bins = 1 << (k - 1).bit_length()
    while bins < n and 1 - (k - 1) / (2 * bins) < recall_target:
        bins *= 2
    return min(bins, n)


class SelectPlan(NamedTuple):
    bins: int            # L
    cluster: int         # blocks per row (a thread-block cluster)
    keys_on_chip: bool   # the bins' keys kept in shared memory (else each
    #                      pass walks the row again)
    sort_on_chip: bool   # the k survivors sorted in shared memory (else in
    #                      the row's int64 indices output)
    stage_row: bool      # the row copied into shared memory and walked there
    smem: int            # dynamic shared memory a block takes, bytes


@functools.lru_cache(maxsize=256)
def select_plan(q: int, n: int, k: int, recall_target: float) -> SelectPlan:
    """Kernel S's launch for ``q`` rows of ``n`` scores, one launch at any
    L: the cluster doubles (up to MAX_CLUSTER) while twice the blocks still
    fit the card's SMS at once and each would own MIN_CLUSTER_BINS bins;
    the k survivors' sort stays in shared memory where 8 k bytes fit a
    block, and the keys of a block's ceil(L / cluster) bins stay beside
    them where those fit too. One block a row with keys on chip stages the
    row in shared memory where its bins hold several elements (L < N) and
    two such blocks still fit an SM."""
    bins = approx_plan(n, k, recall_target)
    cluster = 1
    while (cluster < MAX_CLUSTER and q * 2 * cluster <= SMS
           and bins >= 2 * cluster * MIN_CLUSTER_BINS):
        cluster *= 2
    per = -(-bins // cluster)
    sort_bytes = KEY_BYTES * k
    sort_on_chip = SMEM_FIXED + sort_bytes <= SMEM_LIMIT
    sort_bytes *= sort_on_chip
    keys_on_chip = SMEM_FIXED + sort_bytes + KEY_BYTES * per <= SMEM_LIMIT
    smem = sort_bytes + KEY_BYTES * per * keys_on_chip
    row_bytes = 16 * -(-n // 4)
    stage_row = (cluster == 1 and keys_on_chip and bins < n
                 and 2 * (SMEM_FIXED + smem + row_bytes) <= SMEM_LIMIT)
    return SelectPlan(bins, cluster, keys_on_chip, sort_on_chip, stage_row,
                      smem + row_bytes * stage_row)


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """(Q, N) int64 keys whose order is the rule's: the value's bits mapped
    so that a larger value is a larger int32 (-0.0 as +0.0), times 2^32,
    plus ``0xFFFFFFFF - j``. Every key is distinct."""
    u = scores.float().contiguous().view(torch.int32)
    u = torch.where(u == -2 ** 31, torch.zeros_like(u), u)
    s = torch.where(u < 0, u ^ 0x7FFFFFFF, u).long()
    low = _LOW - torch.arange(scores.shape[1], device=scores.device)
    return s * 2 ** 32 + low


def approx_topk_plain(scores: torch.Tensor, k: int,
                      recall_target: float = 0.95):
    """Plain PyTorch version of the kernel on any device: the rule above on
    (Q, N) f32 scores. Returns (values (Q, k) f32, indices (Q, k) int64)."""
    q, n = scores.shape
    bins = approx_plan(n, k, recall_target)
    keys = order_keys(scores)
    pad = -n % bins
    if pad:  # below every element's key
        keys = torch.cat([keys, keys.new_full((q, pad), -2 ** 63)], 1)
    best = keys.reshape(q, (n + pad) // bins, bins).amax(1)
    top = torch.topk(best, k, dim=1).values  # distinct keys: no tie
    idx = _LOW - (top & _LOW)
    return scores.float().gather(1, idx), idx


def approx_topk(scores: torch.Tensor, k: int, recall_target: float = 0.95):
    """scores: (Q, N) f32. Returns (values (Q, k) f32, indices (Q, k)
    int64), the first k of the rule's ranking. Runs as the custom operator
    ``ganreverser::approx_topk`` (ops/library.py)."""
    cuda_lib.dispatch_device(scores)
    return torch.ops.ganreverser.approx_topk(scores, int(k),
                                             float(recall_target))


def launch_approx_topk(scores: torch.Tensor, k: int, recall_target: float):
    """The body of ``ganreverser::approx_topk``: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if cuda_lib.dispatch_device(scores) == "cpu":
        return approx_topk_plain(scores, k, recall_target)
    q, n = scores.shape
    plan = select_plan(q, n, k, float(recall_target))
    s = scores.contiguous()
    cuda_lib.require(s, "scores", scores.device, torch.float32, (q, n))
    values = torch.empty((q, k), dtype=torch.float32, device=s.device)
    indices = torch.empty((q, k), dtype=torch.int64, device=s.device)
    if q == 0:
        return values, indices
    with cuda_lib.on_device(s):
        rc = cuda_lib.library().gr_approx_topk(
            s.data_ptr(), values.data_ptr(), indices.data_ptr(), q, n, k,
            plan.bins, plan.cluster, int(plan.keys_on_chip),
            int(plan.sort_on_chip), int(plan.stage_row),
            cuda_lib.stream_of(s))
    cuda_lib.check(rc, "approx_topk")
    approx_topk.launches += 1
    return values, indices


cuda_lib.counted(approx_topk)
