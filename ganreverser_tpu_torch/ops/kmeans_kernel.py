"""Kernel K: one Lloyd step of kmeans — assignment and centroid update.

The counterpart of ganreverser_tpu/ops/kmeans_kernel.py (``_kmeans_sums_counts``
and ``kmeans_step_pallas``). Per row the squared distance to each centroid is
the TPU kernel's ``|c|^2 - 2 x.c`` in f32 (``|x|^2`` is constant per row), the
argmin takes the first index on ties, and the step returns the new
centroids ``sums / max(count, 1)``, an empty cluster keeping its centroid,
and the counts. The CUDA kernel (``csrc/kmeans.cu``) assigns the rows in one
launch, streaming the centroids through shared memory in tiles sized by
:func:`kmeans_plan`, and sums each cluster's rows in an order fixed by the
assignment in a second, with no float atomics, so two runs give
bitwise-equal results; any N and K are taken, and D up to about 29,000 (the
ragged end is masked, nothing is padded, so there is no ``n_valid``). X is
cast to f32, as the TPU wrapper casts it.

``kmeans_step`` launches the kernel on CUDA tensors and takes the plain
version ``kmeans_step_plain`` on CPU tensors; no other device is accepted.
``kmeans_step.launches`` counts its calls on the card (one per step, each
two launches).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.precision import pinned_precision
from . import cuda_lib

MAX_ROWS = 64                # rows of X per block of the assignment launch
MAX_SHARED_BYTES = 232_448   # dynamic shared memory a block may use (sm_90)


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


def kmeans_step(x: torch.Tensor, centroids: torch.Tensor, *,
                details: bool = False):
    """x: (N, D), any float dtype (cast to f32); centroids: (K, D). Returns
    what ``kmeans_step_plain`` returns; on CUDA the kernel computes it."""
    if x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and centroids "
                         f"{tuple(centroids.shape)} must be (N, D) and (K, D)")
    n, d = x.shape
    k = centroids.shape[0]
    if n == 0 or k == 0 or d == 0:
        raise ValueError(f"empty kmeans step: N={n}, K={k}, D={d}")
    if cuda_lib.dispatch_device(x, centroids) == "cpu":
        return kmeans_step_plain(x, centroids, details=details)
    plan = kmeans_plan(d, k)
    dev = x.device
    x = x.float().contiguous()
    c = centroids.float().contiguous()
    cuda_lib.require(x, "x", dev, torch.float32, (n, d))
    cuda_lib.require(c, "centroids", dev, torch.float32, (k, d))
    new = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    sums = (torch.empty((k, d), dtype=torch.float32, device=dev)
            if details else None)
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().gr_kmeans_step(
            x.data_ptr(), c.data_ptr(), new.data_ptr(), counts.data_ptr(),
            sums.data_ptr() if details else None, assign.data_ptr(), n, d, k,
            *plan, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "kmeans_step")
    kmeans_step.launches += 1
    return (new, counts, sums, assign.long()) if details else (new, counts)


kmeans_step.launches = 0
