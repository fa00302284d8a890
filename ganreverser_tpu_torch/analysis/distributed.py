"""Mesh-sharded analysis — the counterpart of
ganreverser_tpu/analysis/distributed.py, the 'large-N batch inversion' path
(SURVEY.md §5.7).

The N axis (generated faces, embeddings) is cut over the mesh's 'data'
axis: a rank holds rows ``mesh.rows(N)``. Each rank runs its rows through
the port's fast G (kernel U and U's fused head) and fast R (kernel B),
then the similarity search scores with kernel C and selects with
``torch.topk`` or kernel S, merging the ranks' candidates with one small
all-gather. The JAX package runs module paths here (its Pallas kernels
have no SPMD partitioning rule, cli/apply_r.py:99-108); a rank here
computes its own shard, so the kernels need none.

Weights cut over 'model' (parallel/mesh.py::shard_params) are all-gathered
once per call, then the kernels run on whole weights.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.prng import noise_inputs
from ..models.fastpath import (FIXER_DROPOUT, make_fast_fixer,
                               make_fast_generator, make_fast_inverter)
from ..models.modules import dropout_keep_mask
from ..ops import topk_kernel
from ..parallel.comm import all_gather, psum
from ..parallel.mesh import DATA_AXIS, Mesh
from ..parallel.multihost import gather_replicated
from .batched import forward_batched
from .similarity import select_topk


def fixer_keep_rows(generator: torch.Generator, n: int, batch_size: int,
                    image_shape: tuple, rows: slice) -> torch.Tensor:
    """Rows ``rows`` of the fixer-R's input masks that the one-rank stage
    ② draws for ``n`` images in chunks of ``batch_size``
    (pipeline.generate_and_invert: one draw per chunk, of the chunk's
    padded shape; one of n rows when n fits one chunk). Every chunk's mask
    is drawn, so the generator ends where the one-rank run's does."""
    sizes = ([(0, n, n)] if n <= batch_size else
             [(s, min(s + batch_size, n), batch_size)
              for s in range(0, n, batch_size)])
    parts = []
    for start, stop, size in sizes:
        keep = dropout_keep_mask((size,) + tuple(image_shape), FIXER_DROPOUT,
                                 generator, generator.device)
        lo, hi = max(start, rows.start), min(stop, rows.stop)
        if lo < hi:
            parts.append(keep[lo - start:hi - start])
    return torch.cat(parts)


@torch.inference_mode()
def distributed_generate_and_invert(g_variables: dict, r_variables: dict, *,
                                    dims: tuple, n: int, noise_dim: int,
                                    noise_method: str,
                                    generator: torch.Generator, mesh: Mesh,
                                    batch_size: int = 1024,
                                    dtype: torch.dtype = torch.float32,
                                    g_specs=None, r_specs=None,
                                    rf_variables: Optional[dict] = None,
                                    rf_specs=None,
                                    fixer_generator: Optional[
                                        torch.Generator] = None):
    """Stage ② with N cut over 'data' (pipeline.generate_and_invert on
    this rank's rows): every rank draws the N latents from ``generator``
    (the same stream everywhere) and keeps its rows, gathers the weights
    that ``*_specs`` (parallel/mesh.py::param_specs of the whole trees)
    cut over 'model', and runs the fast G and R on its rows in chunks of
    ``batch_size``; with ``rf_variables`` the fast fixer-R on the same
    rows, its masks the rows of the one-rank run's masks
    (:func:`fixer_keep_rows`). N must divide over the data axis.

    Returns (noise, images, attributes[, attributes_fixer]), this rank's
    rows."""
    rows = mesh.rows(n)
    device = generator.device
    noise = noise_inputs(generator, n, noise_dim, noise_method,
                         device=device)[rows]
    g_variables = gather_replicated(g_variables, mesh, g_specs)
    r_variables = gather_replicated(r_variables, mesh, r_specs)
    generate = make_fast_generator(dims, noise_dim, dtype)
    invert = make_fast_inverter(dims, noise_dim, noise_method, dtype)
    g_prep = generate.prepare(g_variables)
    images = forward_batched(lambda z: generate.run(g_prep, z), noise,
                             batch_size)
    r_prep = invert.prepare(r_variables)
    attributes = forward_batched(lambda x: invert.run(r_prep, x), images,
                                 batch_size)
    if rf_variables is None:
        return noise, images, attributes
    rf_variables = gather_replicated(rf_variables, mesh, rf_specs)
    invert_fixer = make_fast_fixer(dims, noise_dim, noise_method, dtype)
    keep = fixer_keep_rows(fixer_generator, n, batch_size, images.shape[1:],
                           rows)
    rf_prep = invert_fixer.prepare(rf_variables)
    # chunks of row indices, so that each chunk's images and mask travel
    # together (and the last chunk is padded as the images' would be)
    attributes_fixer = forward_batched(
        lambda idx: invert_fixer.run(rf_prep, images[idx], keep=keep[idx]),
        torch.arange(images.shape[0], device=device), batch_size)
    return noise, images, attributes, attributes_fixer


def _needle_rows(embeddings: torch.Tensor, needle_idx: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """The (Q, D) needle rows, global indices ``needle_idx``, on every
    rank: each rank contributes the needles among its rows (zeros
    elsewhere) to a sum over the 'data' group."""
    local_n = embeddings.shape[0]
    lo = mesh.axis_index(DATA_AXIS) * local_n
    idx = needle_idx.to(embeddings.device)
    mine = (idx >= lo) & (idx < lo + local_n)
    rows = embeddings.index_select(0, (idx - lo).clamp(0, local_n - 1))
    contrib = torch.where(mine[:, None], rows.float(), 0.0)
    return psum(contrib, mesh).to(embeddings.dtype)


@torch.inference_mode()
def distributed_cosine_topk(embeddings: torch.Tensor,
                            needle_idx: torch.Tensor, k: int, mesh: Mesh,
                            approx: bool = False,
                            recall_target: float = 0.95):
    """Global top-k cosine search over embeddings cut over 'data'.

    ``embeddings``: this rank's rows; ``needle_idx``: global row indices,
    the same on every rank. The needles reach every rank through one sum
    over the 'data' group; each rank scores them against its rows with
    kernel C (on its rows with the needles appended, the needles' own
    columns dropped) and selects its top min(k, rows) with ``torch.topk``
    or, with ``approx``, kernel S at ``recall_target`` (the per-shard
    recall bound carries to the global result); the (value, global index)
    candidates are all-gathered and a final exact top-k taken. Exact by
    default: the global top-k is a subset of the union of local top-ks.

    Returns (values, indices) (Q, k), the same on every rank."""
    local_n = embeddings.shape[0]
    q = needle_idx.shape[0]
    kk = min(k, local_n)
    needles = _needle_rows(embeddings, needle_idx, mesh)
    corpus = topk_kernel.padded_corpus(torch.cat([embeddings, needles]))
    cols = torch.arange(local_n, local_n + q, device=embeddings.device)
    scores = topk_kernel.cosine_scores(corpus, cols)[:, :local_n]
    v, i = select_topk(scores, kk, approx, recall_target)
    gi = i + mesh.axis_index(DATA_AXIS) * local_n
    v_all = all_gather(v, mesh, DATA_AXIS, axis=1)
    gi_all = all_gather(gi, mesh, DATA_AXIS, axis=1)
    fv, fi = torch.topk(v_all, k, dim=1)
    return fv, torch.gather(gi_all, 1, fi)
