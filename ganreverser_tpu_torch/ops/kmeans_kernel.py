"""Kernel K: Lloyd's iterations of kmeans — assignment and centroid update.

The counterpart of ganreverser_tpu/ops/kmeans_kernel.py (``_kmeans_sums_counts``,
``kmeans_step_pallas`` and the loop of ``kmeans_pallas``). Per row the squared
distance to each centroid is the TPU kernel's ``|c|^2 - 2 x.c`` in f32
(``|x|^2`` is constant per row), the argmin takes the first index on ties,
and a step returns the new centroids ``sums / max(count, 1)``, an empty
cluster keeping its centroid, and the counts. The CUDA kernel
(``csrc/kmeans.cu``) runs every iteration in one cooperative launch: the
rows are assigned with the centroids streaming through shared memory in
tiles sized by :func:`kmeans_plan`, sorted by cluster (stable in row
order), and each cluster's rows are summed in segments of
:data:`SEG_ROWS` sorted rows, then the segments in order
(:func:`kmeans_segment_sums_plain` is that order in plain PyTorch). No
float atomics, so two runs give bitwise-equal results; any N and K are
taken, and D up to about 29,000 (the ragged end is masked, nothing is
padded, so there is no ``n_valid``). X is cast to f32, as the TPU wrapper
casts it.

``kmeans_lloyd`` runs ``iters`` iterations in one launch and
``kmeans_step`` one, both on CUDA tensors; on CPU tensors they take the
plain versions ``kmeans_lloyd_plain`` and ``kmeans_step_plain``; no other
device is accepted. ``kmeans_lloyd.launches`` and ``kmeans_step.launches``
count their launches on the card (one per call). :func:`lloyd_plan` sizes
the launch's grid (the co-resident blocks, at most one per tile of rows)
and its workspace; a grid the card cannot hold at once is refused by the
cooperative launch, and the wrapper raises with the plan.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.precision import pinned_precision
from . import cuda_lib

MAX_ROWS = 64                # rows of X per block of the assignment launch
MAX_SHARED_BYTES = 232_448   # dynamic shared memory a block may use (sm_90)
THREADS = 256                # threads per block of the Lloyd kernel
SEG_ROWS = 64                # sorted rows per segment sum (csrc/kmeans.cu)


class KmeansPlan(NamedTuple):
    rows: int        # rows of X held by one block of the assignment launch
    kt: int          # centroids per shared-memory tile
    smem_bytes: int  # that block's dynamic shared memory


def _assign_bytes(d: int, rows: int, kt: int) -> int:
    # rows and a centroid tile at the odd stride D + 1, the tile's squared
    # norms and the (rows, kt) dot products (csrc/kmeans.cu)
    return 4 * ((rows + kt) * (d + 1) + kt + rows * kt)


def kmeans_plan(d: int, k: int) -> KmeansPlan:
    """The assignment launch's tiles for (K, D): up to 64 rows and 64
    centroids, halving the larger of the two until one block's shared
    memory fits in 227 KB. Raises for a D whose single row and centroid do
    not fit (about 29,000)."""
    rows, kt = MAX_ROWS, min(k, MAX_ROWS)
    while _assign_bytes(d, rows, kt) > MAX_SHARED_BYTES:
        if rows == kt == 1:
            raise ValueError(f"D={d}: one row and one centroid need "
                             f"{_assign_bytes(d, 1, 1)} bytes of shared "
                             f"memory, over {MAX_SHARED_BYTES}")
        if rows >= kt:
            rows //= 2
        else:
            kt //= 2
    return KmeansPlan(rows, kt, _assign_bytes(d, rows, kt))


def _finish(sums, counts, centroids):
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centroids.float())


def kmeans_step_plain(x: torch.Tensor, centroids: torch.Tensor, *,
                      details: bool = False):
    """Plain PyTorch version of the kernel on any device, in IEEE f32 (the
    matrix products are pinned, core/precision.py). Returns (new_centroids
    (K, D), counts (K,)), both f32, and with ``details`` also the raw sums
    (K, D) and the assignment (N,) int64."""
    x = x.float()
    c = centroids.float()
    with pinned_precision(torch.float32):
        d = (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)
        assign = torch.argmin(d, dim=1)
        onehot = F.one_hot(assign, c.shape[0]).float()
        sums = onehot.T @ x
    counts = onehot.sum(0)
    new = _finish(sums, counts, c)
    return (new, counts, sums, assign) if details else (new, counts)


class LloydPlan(NamedTuple):
    rows: int             # rows of a tile of the assignment (<= kmeans_plan's)
    kt: int               # centroids per shared-memory tile
    smem_bytes: int       # a block's dynamic shared memory
    grid: int             # co-resident blocks of the cooperative launch
    tiles_per_block: int  # a block's contiguous tiles of rows
    max_segments: int     # segment sums the workspace holds
    ws_floats: int        # 2 (K, D) centroid buffers, K norms, segment sums
    ws_ints: int          # permutation, (K, grid) table, counts, starts,
    #                       the segments' clusters


def lloyd_plan(n: int, d: int, k: int, resident: int) -> LloydPlan:
    """The Lloyd launch for (N, D, K) on a card holding ``resident`` blocks
    of it at once: the assignment's tiles (:func:`kmeans_plan`, whose
    shared memory a block gets), with fewer rows a tile (a multiple of 4)
    where that spreads N over more of the resident blocks; one block per
    tile up to ``resident`` (each block a contiguous run of tiles); and the
    workspace. The segments number at most min(N, ceil(N / 64) + K),
    since a cluster of c rows has ceil(c / 64) of them."""
    if resident <= 0:
        raise RuntimeError(f"no block of the Lloyd kernel fits on the card "
                           f"(N={n}, D={d}, K={k})")
    rows, kt, smem = kmeans_plan(d, k)
    if rows >= 4:  # fill the resident blocks: fewer rows a tile, in fours
        rows = min(rows, 4 * -(-n // (4 * resident)))
    tiles = -(-n // rows)
    per_block = -(-tiles // min(resident, tiles))
    grid = -(-tiles // per_block)
    max_segments = min(n, -(-n // SEG_ROWS) + k)
    return LloydPlan(rows, kt, max(smem, 4 * THREADS), grid, per_block,
                     max_segments, 2 * k * d + k + max_segments * d,
                     n + k * grid + 3 * k + 2 + max_segments)


@functools.lru_cache(maxsize=None)
def resident_blocks(smem_bytes: int, device_index: int) -> int:
    """Blocks of the Lloyd kernel the card holds at once with this much
    shared memory (occupancy x SMs), queried once per (size, device)."""
    with torch.cuda.device(device_index):
        return cuda_lib.library().gr_kmeans_resident(smem_bytes)


def card_plan(n: int, d: int, k: int, device_index: int) -> LloydPlan:
    """:func:`lloyd_plan` with the resident blocks of the card
    ``device_index``."""
    smem = max(kmeans_plan(d, k).smem_bytes, 4 * THREADS)
    return lloyd_plan(n, d, k, resident_blocks(smem, device_index))


def kmeans_segment_sums_plain(x: torch.Tensor, assign: torch.Tensor,
                              k: int):
    """The kernel's sums of the rows of each cluster, in its order: the
    rows sorted by cluster (stable), each cluster's sorted rows added in
    segments of SEG_ROWS in order, then its segments in order, all in f32
    from 0. Returns (sums (K, D), counts (K,)), f32."""
    x = x.float()
    n, d = x.shape
    assign = assign.long()
    order = torch.sort(assign, stable=True).indices
    counts = torch.bincount(assign, minlength=k)
    starts = torch.cumsum(counts, 0) - counts
    nseg = (counts + SEG_ROWS - 1) // SEG_ROWS
    segstart = torch.cumsum(nseg, 0) - nseg
    segk = torch.repeat_interleave(torch.arange(k, device=x.device), nseg)
    p0 = starts[segk] + SEG_ROWS * (torch.arange(segk.numel(),
                                                 device=x.device)
                                    - segstart[segk])
    length = starts[segk] + counts[segk] - p0
    segsum = torch.zeros(segk.numel(), d, device=x.device)
    for i in range(min(SEG_ROWS, n)):
        has = (i < length)[:, None]
        rows = order[torch.clamp(p0 + i, max=n - 1)]
        segsum = torch.where(has, segsum + x[rows], segsum)
    sums = torch.zeros(k, d, device=x.device)
    for j in range(int(nseg.max())):
        has = (j < nseg)[:, None]
        s = torch.clamp(segstart + j, max=max(segk.numel() - 1, 0))
        sums = torch.where(has, sums + segsum[s], sums)
    return sums, counts.float()


def kmeans_lloyd_plain(x: torch.Tensor, centroids: torch.Tensor, iters: int,
                       *, details: bool = False):
    """``iters`` plain steps (:func:`kmeans_step_plain`) from ``centroids``.
    Returns what the last step returns (zero counts and the centroids in
    f32 when ``iters`` is 0, without ``details``)."""
    c = centroids.float()
    if iters == 0:
        if details:
            raise ValueError("details need at least one iteration")
        return c.clone(), torch.zeros(c.shape[0], device=c.device)
    for _ in range(iters):
        out = kmeans_step_plain(x, c, details=details)
        c = out[0]
    return out


def _check(x: torch.Tensor, centroids: torch.Tensor, iters: int) -> None:
    if x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and centroids "
                         f"{tuple(centroids.shape)} must be (N, D) and (K, D)")
    n, d = x.shape
    k = centroids.shape[0]
    if n == 0 or k == 0 or d == 0:
        raise ValueError(f"empty kmeans: N={n}, K={k}, D={d}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def _launch(x: torch.Tensor, centroids: torch.Tensor, iters: int,
            details: bool):
    """One launch of the Lloyd kernel for ``iters`` >= 1 iterations."""
    n, d = x.shape
    k = centroids.shape[0]
    dev = x.device
    plan = card_plan(n, d, k, dev.index)
    x = x.float().contiguous()
    c = centroids.float().contiguous()
    cuda_lib.require(x, "x", dev, torch.float32, (n, d))
    cuda_lib.require(c, "centroids", dev, torch.float32, (k, d))
    new = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    sums = (torch.empty((k, d), dtype=torch.float32, device=dev)
            if details else None)
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    ws_f = torch.empty((plan.ws_floats,), dtype=torch.float32, device=dev)
    ws_i = torch.empty((plan.ws_ints,), dtype=torch.int32, device=dev)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_kmeans_lloyd(
            x.data_ptr(), c.data_ptr(), new.data_ptr(), counts.data_ptr(),
            sums.data_ptr() if details else None, assign.data_ptr(),
            ws_f.data_ptr(), ws_i.data_ptr(), n, d, k, iters, plan.rows,
            plan.kt, plan.smem_bytes, plan.grid, plan.tiles_per_block,
            plan.max_segments, cuda_lib.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"kmeans Lloyd kernel refused or failed to launch "
                           f"(cudaError {rc}) with {plan} for N={n}, D={d}, "
                           f"K={k}: a cooperative launch needs every block "
                           f"of the grid resident at once")
    return (new, counts, sums, assign.long()) if details else (new, counts)


def kmeans_lloyd(x: torch.Tensor, centroids: torch.Tensor, iters: int, *,
                 details: bool = False):
    """``iters`` Lloyd iterations from ``centroids``: x (N, D), any float
    dtype (cast to f32); centroids (K, D). Returns what
    ``kmeans_lloyd_plain`` returns; on CUDA one launch of the kernel
    computes it (none for ``iters`` = 0)."""
    _check(x, centroids, iters)
    if cuda_lib.dispatch_device(x, centroids) == "cpu" or iters == 0:
        return kmeans_lloyd_plain(x, centroids, iters, details=details)
    out = _launch(x, centroids, iters, details)
    kmeans_lloyd.launches += 1
    return out


cuda_lib.counted(kmeans_lloyd)


def kmeans_step(x: torch.Tensor, centroids: torch.Tensor, *,
                details: bool = False):
    """One Lloyd step: x (N, D), any float dtype (cast to f32); centroids
    (K, D). Returns what ``kmeans_step_plain`` returns; on CUDA one launch
    of the Lloyd kernel computes it."""
    _check(x, centroids, 1)
    if cuda_lib.dispatch_device(x, centroids) == "cpu":
        return kmeans_step_plain(x, centroids, details=details)
    out = _launch(x, centroids, 1, details)
    kmeans_step.launches += 1
    return out


cuda_lib.counted(kmeans_step)
