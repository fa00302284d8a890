"""Kernel K: one Lloyd step of kmeans — assignment and centroid update from a
single read of X.

The counterpart of ganreverser_tpu/ops/kmeans_kernel.py (``_kmeans_sums_counts``
and ``kmeans_step_pallas``). Per row the squared distance to each centroid is
the TPU kernel's ``|c|^2 - 2 x.c`` in f32 (``|x|^2`` is constant per row), the
argmin takes the first index on ties, and the step returns the new
centroids ``sums / max(count, 1)``, an empty cluster keeping its centroid,
and the counts. The CUDA kernel (``csrc/kmeans.cu``) reduces its per-block
partial sums in a fixed order, with no float atomics, so two runs give
bitwise-equal results; any N is taken (the ragged end is masked, nothing is
padded, so there is no ``n_valid``). X is cast to f32, as the TPU wrapper
casts it.

``kmeans_step`` launches the kernel on CUDA tensors and takes the plain
version ``kmeans_step_plain`` on CPU tensors; no other device is accepted.
``kmeans_step.launches`` counts kernel launches (one per step).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.precision import pinned_precision
from . import cuda_lib

ROWS_PER_BLOCK = 64          # kRows of csrc/kmeans.cu
MAX_SHARED_BYTES = 232_448   # dynamic shared memory a block may use (sm_90)


def shared_bytes(d: int, k: int) -> int:
    """Shared memory of one stage-1 block (csrc/kmeans.cu::
    kmeans_smem_floats): centroids, their norms, the rows, the dot
    products, the (K, D+1) accumulator and the rows' assignments."""
    r = ROWS_PER_BLOCK
    return 4 * (k * d + k + r * d + r * k + k * (d + 1) + r)


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
    if shared_bytes(d, k) > MAX_SHARED_BYTES:
        raise ValueError(f"K={k}, D={d} needs {shared_bytes(d, k)} bytes of "
                         f"shared memory per block, over {MAX_SHARED_BYTES}")
    dev = x.device
    x = x.float().contiguous()
    c = centroids.float().contiguous()
    cuda_lib.require(x, "x", dev, torch.float32, (n, d))
    cuda_lib.require(c, "centroids", dev, torch.float32, (k, d))
    blocks = -(-n // ROWS_PER_BLOCK)
    ws = torch.empty(blocks * k * (d + 1), dtype=torch.float32, device=dev)
    new = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    sums = (torch.empty((k, d), dtype=torch.float32, device=dev)
            if details else None)
    assign = (torch.empty((n,), dtype=torch.int32, device=dev)
              if details else None)
    with torch.cuda.device(dev):
        rc = cuda_lib.library().gr_kmeans_step(
            x.data_ptr(), c.data_ptr(), ws.data_ptr(), ws.numel(),
            new.data_ptr(), counts.data_ptr(),
            sums.data_ptr() if details else None,
            assign.data_ptr() if details else None, n, d, k,
            cuda_lib.stream_of(x))
    cuda_lib.check(rc, "kmeans_step")
    kmeans_step.launches += 1
    return (new, counts, sums, assign.long()) if details else (new, counts)


kmeans_step.launches = 0
