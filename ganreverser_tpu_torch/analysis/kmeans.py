"""kmeans and the cluster membership of apply_r.lua (197-260), the
counterpart of ganreverser_tpu/analysis/kmeans.py.

Lloyd iterations go through kernel K (ops/kmeans_kernel.py): on CUDA one
launch runs them all, with no host synchronisation; on the CPU its plain
version runs.

The reference's membership step has a quirk, kept behind its own function:
after kmeans every image goes to the centroid with the MINIMUM cosine
similarity, and members are sorted by descending similarity
(apply_r.lua:206-224). ``assign_euclidean`` is the sane variant.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import pinned_precision
from ..ops.kmeans_kernel import kmeans_lloyd
from .similarity import normalize_rows


def kmeans(x: torch.Tensor, k: int, iters: int, *,
           generator: torch.Generator | None = None, init_idx=None):
    """Lloyd's algorithm from ``k`` distinct data points (unsup.kmeans's
    init): ``torch.randperm(N, generator=generator)[:k]``, or the row
    indices ``init_idx`` when given (the tests pass the ones
    ``jax.random.choice`` drew). Returns (centroids (K, D), counts (K,)),
    f32; the counts are those of the last step (zeros when ``iters`` is
    0)."""
    x = x.float().contiguous()
    n = x.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= N, got k={k}, N={n}")
    if init_idx is None:
        if generator is None:
            raise ValueError("kmeans needs a generator or init_idx")
        init_idx = torch.randperm(n, generator=generator,
                                  device=generator.device)[:k]
    init_idx = torch.as_tensor(init_idx, dtype=torch.int64, device=x.device)
    return kmeans_lloyd(x, x.index_select(0, init_idx), iters)


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, K) squared distances by the lax path's expansion
    |x|^2 - 2 x.c + |c|^2 (not kernel K's formula)."""
    with pinned_precision(torch.float32):
        xc = x @ c.T
    return (x * x).sum(1, keepdim=True) - 2.0 * xc + (c * c).sum(1)[None, :]


def assign_euclidean(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid by euclidean distance: (assignment (N,) int64,
    distance (N,) f32)."""
    d = _pairwise_sq_dists(x.float(), centroids.float())
    assign = torch.argmin(d, dim=1)
    return assign, torch.sqrt(d.gather(1, assign[:, None])[:, 0])


def assign_min_cosine(x: torch.Tensor, centroids: torch.Tensor):
    """The reference's assignment: the 'best' cluster is the one of MINIMUM
    cosine similarity (apply_r.lua:206-218). Returns (assignment (N,)
    int64, similarity (N,) f32)."""
    with pinned_precision(torch.float32):
        sims = normalize_rows(x) @ normalize_rows(centroids).T
    assign = torch.argmin(sims, dim=1)
    return assign, sims.gather(1, assign[:, None])[:, 0]


def cluster_members(assign, score, cluster: int,
                    max_per_cluster: int) -> np.ndarray:
    """Host side: the member indices of one cluster by DESCENDING score
    (a stable sort), truncated (apply_r.lua:222-230)."""
    assign = np.asarray(assign)
    score = np.asarray(score)
    members = np.nonzero(assign == cluster)[0]
    order = members[np.argsort(-score[members], kind="stable")]
    return order[:max_per_cluster]
