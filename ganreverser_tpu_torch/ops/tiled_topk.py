"""Two-pass tiled top-k, the counterpart of ganreverser_tpu/ops/tiled_topk.py.

An exact selection in two passes over a (Q, N) score matrix:

  pass 1: split N into tiles, the top-k within each tile;
  pass 2: the top-k of the T * k survivors.

The global top-k is a subset of the union of the tiles' top-k, so the result
is exact. Both passes are ``torch.topk``, as the JAX module's are
``lax.top_k`` outside any Pallas kernel. Neither the fused program nor
``apply_r`` runs it, as in JAX; ``chip_smoke.py`` times it beside one
``torch.topk`` at the pixel search's shape (PERF.md).
"""
from __future__ import annotations

import torch


def tiled_topk(scores: torch.Tensor, k: int, tile: int = 2048):
    """Exact top-k along the last axis of (Q, N) by the two-pass scheme.
    N is padded up to a multiple of the tile with -inf (never selected while
    k <= N). Returns (values, indices (int64)), sorted descending."""
    q, n = scores.shape
    if not 1 <= k <= n:
        raise ValueError(f"k must lie in 1..{n}, got {k}")
    tile = min(tile, n)
    pad = -n % tile
    if pad:
        scores = torch.cat([scores, scores.new_full((q, pad), -float("inf"))],
                           1)
    t = (n + pad) // tile
    kk = min(k, tile)
    v, i = torch.topk(scores.reshape(q, t, tile), kk, dim=2)   # (q, t, kk)
    i = i + (torch.arange(t, device=i.device) * tile)[None, :, None]
    fv, fi = torch.topk(v.reshape(q, t * kk), k, dim=1)
    return fv, i.reshape(q, t * kk).gather(1, fi)


def pixel_cosine_topk_tiled(images: torch.Tensor, needle_idx: torch.Tensor,
                            k: int, tile: int = 2048):
    """apply_r.lua:307-314's pixel-space search with the two-pass
    selection: the scores are the plain composition of
    analysis/similarity.py (as JAX's are its lax path), the selection
    :func:`tiled_topk`."""
    from ..analysis.similarity import cosine_scores
    flat = images.reshape(images.shape[0], -1)
    return tiled_topk(cosine_scores(flat, needle_idx), k, tile)
