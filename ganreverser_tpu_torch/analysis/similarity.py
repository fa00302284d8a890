"""Cosine-similarity search — apply_r.lua:265-318, the counterpart of
ganreverser_tpu/analysis/similarity.py.

``cosine_topk`` and ``pixel_cosine_topk`` go through kernel C
(ops/topk_kernel.py) for the scores, then :func:`select_topk`: exact
``torch.topk`` by default, or with ``approx=True`` kernel S
(ops/approx_topk_kernel.py), the counterpart of JAX's
``jax.lax.approx_max_k``, at ``recall_target``. On CUDA the kernels
launch, on the CPU their plain versions run. ``normalize_rows`` and
``cosine_scores`` are the plain composition with the torch
nn.CosineDistance clamp of the norm at 1e-8; kernel C clamps the squared
norm at 1e-16, which differs only on degenerate rows.
:class:`SimilarityIndex` keeps a corpus normalised once for repeated
queries.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import pinned_precision
from ..ops import approx_topk_kernel, topk_kernel

_EPS = 1e-8


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    norm = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / torch.clamp_min(norm, _EPS)


def cosine_scores(embeddings: torch.Tensor,
                  needle_idx: torch.Tensor) -> torch.Tensor:
    """(needles, N) cosine similarity of each needle against every row."""
    normed = normalize_rows(embeddings)
    return normed.index_select(0, needle_idx) @ normed.T


def select_topk(scores: torch.Tensor, k: int, approx: bool = False,
                recall_target: float = 0.95):
    """The top-k of each row of (Q, N) f32 scores, (values, indices),
    descending: ``torch.topk``, or with ``approx`` kernel S's approximate
    selection at ``recall_target`` (JAX ``_select_topk``). Either way the
    returned k are ranked exactly among themselves."""
    if approx:
        return approx_topk_kernel.approx_topk(scores, k, recall_target)
    return torch.topk(scores, k, dim=1)


def cosine_topk(embeddings: torch.Tensor, needle_idx: torch.Tensor, k: int,
                approx: bool = False, recall_target: float = 0.95):
    """Top-k most-similar rows per needle: (scores (needles, k), indices
    (needles, k)), sorted descending (apply_r.lua:275-278). ``approx``
    selects approximately at ``recall_target`` (:func:`select_topk`)."""
    return select_topk(topk_kernel.cosine_scores(embeddings, needle_idx), k,
                       approx, recall_target)


def pixel_cosine_topk(images: torch.Tensor, needle_idx: torch.Tensor, k: int,
                      approx: bool = False, recall_target: float = 0.95):
    """The reference's second measure: cosine over flattened pixels
    (apply_r.lua:307-314)."""
    return cosine_topk(images.reshape(images.shape[0], -1), needle_idx, k,
                       approx, recall_target)


def topk_recall(exact_idx, test_idx) -> float:
    """Mean per-needle recall of ``test_idx`` against ``exact_idx`` (both
    (needles, k) index arrays): |exact & test| / k, averaged."""
    exact_idx = np.asarray(exact_idx)
    test_idx = np.asarray(test_idx)
    hits = sum(len(np.intersect1d(e, t)) for e, t in zip(exact_idx, test_idx))
    return hits / exact_idx.size


def scores_against(queries: torch.Tensor, corpus: torch.Tensor):
    """(Q, N) f32 products of rows already normalised, f32 sums at the
    precision pinned for the operands' dtype (core/precision.py): the
    plain ``jnp.dot(..., preferred_element_type=f32)`` of the JAX search,
    outside any kernel."""
    with pinned_precision(queries.dtype):
        return queries.float() @ corpus.float().T


class SimilarityIndex:
    """Cosine search over a corpus normalised once and kept on its device
    (JAX ``similarity.py:119-147``), for repeated queries: ``cosine_topk``
    normalises the whole corpus on every call.

    ``topk_by_index`` scores corpus rows (the apply_r pattern,
    apply_r.lua:270-276) through kernel C on the stored rows;
    ``topk`` scores free query vectors, normalised here, with one plain
    product against the stored rows (the JAX index's ``jnp.dot``). Both
    select with :func:`select_topk`."""

    def __init__(self, embeddings: torch.Tensor):
        self._normed = normalize_rows(embeddings)

    @property
    def size(self) -> int:
        return self._normed.shape[0]

    def topk(self, queries: torch.Tensor, k: int, *, approx: bool = False,
             recall_target: float = 0.95):
        """(Q, D) query vectors -> (scores (Q, k), indices (Q, k))."""
        return select_topk(scores_against(normalize_rows(queries),
                                          self._normed), k, approx,
                           recall_target)

    def topk_by_index(self, needle_idx: torch.Tensor, k: int, *,
                      approx: bool = False, recall_target: float = 0.95):
        """(Q,) corpus rows as needles -> (scores (Q, k), indices (Q, k))."""
        return select_topk(topk_kernel.cosine_scores(self._normed,
                                                     needle_idx), k, approx,
                           recall_target)
