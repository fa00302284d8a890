"""The composed generate→invert→top-k pipeline as one program, the
counterpart of ganreverser_tpu/analysis/e2e.py.

The reference runs apply_r's main loop on the host: createImages
(apply_r.lua:143-147), forwardBatched through R (apply_r.lua:150-153), then
the needle-by-needle cosine search (apply_r.lua:265-318). Here:

* the G→R leg is one chunk loop in which each chunk's images feed R at
  once, so the full (N, H, W, C) image tensor is never stored;
* the similarity search takes every generated face as a needle, in
  needle chunks over the embeddings, each chunk one launch of kernel C
  (ops/topk_kernel.py, row-normalisation and scores) and a selection:
  ``torch.topk``, or with ``approx=True`` kernel S
  (ops/approx_topk_kernel.py) at ``recall_target``;
* ``pixel_k > 0`` adds the reference's second measure, cosine over the
  flattened pixels (apply_r.lua:307-314): the chunk loop also keeps each
  chunk's flat images in the compute dtype, and the same search ranks
  them, kernel C normalising the rows (JAX keeps an f32 normalised copy
  instead; the function is the same);
* on CUDA tensors the whole program (prepare the weights, the chunk loop,
  both searches) is one CUDA graph, captured at the first call and
  replayed after (analysis/graphs.py), the analogue of JAX's one jitted
  program.

``make_serial_programs`` builds the unfused three programs (generate-all,
invert-all, search-all), each captured the same way, so that what the
fusion buys is measured against graphs, not against eager code.

G and R are the port's modules (models/zoo.py); with no ``g_apply`` or
``r_apply`` the module runs in evaluation on the variables it is given
(JAX's ``G.apply(variables, x, train=False)``). The fast forwards of
models/fastpath.py (kernels U and B) are the overrides the card runs; a
:class:`~..models.fastpath.FastForward` is prepared once per call,
outside the chunk loop.

``make_distributed_e2e_program`` is the same program with z cut over a
mesh's 'data' axis (parallel/mesh.py): each rank runs the chunk loop on
its rows (one CUDA graph), one tiled all-gather brings every rank the
whole embedding corpus, and each rank searches its own rows against it;
the pixel measure passes the flat-image blocks around a ``ppermute`` ring
instead of gathering them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.fastpath import (FastForward, make_fast_generator,
                               make_fast_generator_int8, make_fast_inverter,
                               make_fast_inverter_int8)
from ..ops import topk_kernel
from .batched import forward_batched
from ..parallel.comm import all_gather, ppermute
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from .graphs import CapturedProgram
from .similarity import scores_against, select_topk


def fast_legs(dims: tuple, noise_dim: int, noise_method: str,
              dtype: torch.dtype = torch.bfloat16, int8: bool = False) -> dict:
    """``{"g_apply", "r_apply"}``: the fast G (kernel U and U's fused head)
    and the fast R (kernel B) of models/fastpath.py,
    the legs the card runs in :func:`make_e2e_program` and
    :func:`make_serial_programs`; with ``int8`` the int8 G and R (kernels
    Q1-Q4)."""
    if int8:
        return {"g_apply": make_fast_generator_int8(dims, noise_dim, dtype),
                "r_apply": make_fast_inverter_int8(dims, noise_dim,
                                                   noise_method, dtype)}
    return {"g_apply": make_fast_generator(dims, noise_dim, dtype),
            "r_apply": make_fast_inverter(dims, noise_dim, noise_method,
                                          dtype)}


def chunked_topk_search(queries_normed: torch.Tensor,
                        corpus_normed: torch.Tensor, k: int,
                        needle_chunk: int = 256, approx: bool = False,
                        recall_target: float = 0.95):
    """Top-k corpus rows per query, the queries streamed in chunks of
    ``needle_chunk``; both operands row-normalised. Each chunk is one plain
    product (JAX's ``jnp.dot``, f32 sums) and a selection
    (``similarity.select_topk``: ``torch.topk``, or kernel S with
    ``approx``), so the (Q, N) score matrix is never whole. Returns
    (values (Q, k), indices (Q, k))."""
    q = queries_normed.shape[0]
    pad = -(-q // needle_chunk) * needle_chunk - q
    # zero-row padding, not a repeat of the first rows, which would
    # under-pad a query set smaller than half a chunk
    qq = F.pad(queries_normed, (0, 0, 0, pad)) if pad else queries_normed
    vs, ids = [], []
    for qc in qq.split(needle_chunk):
        v, i = select_topk(scores_against(qc, corpus_normed), k, approx,
                           recall_target)
        vs.append(v)
        ids.append(i)
    return torch.cat(vs)[:q], torch.cat(ids)[:q]


def topk_all(embeddings: torch.Tensor, k: int, needle_chunk: int = 256,
             approx: bool = False, recall_target: float = 0.95,
             rows: slice | None = None):
    """Top-k most similar rows for every row (or for the needle rows
    ``rows`` only), in chunks of needles: each chunk is one call of kernel
    C with the chunk's rows as needles (``needle_idx = arange(s, s +
    chunk)``) on the un-normalised corpus, then the selection
    (``torch.topk``, or kernel S with ``approx``); the last chunk is
    shorter. The corpus is padded for the kernel once per search
    (``topk_kernel.padded_corpus``)."""
    n = embeddings.shape[0]
    rows = rows or slice(0, n)
    corpus = topk_kernel.padded_corpus(embeddings)
    needles = torch.arange(rows.start, rows.stop, device=embeddings.device)
    vs, ids = [], []
    for s in range(0, needles.shape[0], needle_chunk):
        v, i = select_topk(topk_kernel.cosine_scores(
            corpus, needles[s:s + needle_chunk]), k, approx, recall_target)
        vs.append(v)
        ids.append(i)
    return torch.cat(vs), torch.cat(ids)


def _flat_variables(tree: dict, prefix: str = "") -> dict:
    out = {}
    for name, v in tree.items():
        key = f"{prefix}{name}"
        if isinstance(v, dict):
            out.update(_flat_variables(v, key + "."))
        else:
            out[key] = v
    return out


def _module_apply(model: nn.Module) -> FastForward:
    """``(variables, x) -> y``: ``model`` in evaluation on the variables it
    is given (a ``{"params", "state"}`` tree), JAX's
    ``model.apply(variables, x, train=False)[0]``. Puts ``model`` in
    evaluation."""
    model.eval()

    def prepare(variables):
        return {**_flat_variables(variables["params"]),
                **_flat_variables(variables["state"])}

    def run(flat, x):
        return torch.func.functional_call(model, flat, (x,))

    return FastForward(prepare, run)


def _as_forward(apply: Optional[Callable], model: nn.Module) -> FastForward:
    """``apply`` as a prepare/run pair: a FastForward as it is, any other
    ``(variables, x)`` callable with nothing to prepare, None the module."""
    if apply is None:
        return _module_apply(model)
    if isinstance(apply, FastForward):
        return apply
    return FastForward(lambda variables: variables, apply)


def _g_then_r_fn(g: FastForward, r: FastForward, pixels: bool):
    """The per-chunk fused leg on prepared weights: z chunk -> R embedding,
    and with ``pixels`` also the chunk's flat images."""

    def g_then_r(g_prepared, r_prepared, zc):
        images = g.run(g_prepared, zc)
        emb = r.run(r_prepared, images)
        if pixels:
            return emb, images.reshape(images.shape[0], -1)
        return emb

    return g_then_r


def make_e2e_forward(G: Optional[nn.Module], R: Optional[nn.Module], *,
                     batch_size: int = 128, k: int = 100,
                     needle_chunk: int = 256,
                     g_apply: Optional[Callable] = None,
                     r_apply: Optional[Callable] = None,
                     approx: bool = False, recall_target: float = 0.95,
                     pixel_k: int = 0) -> FastForward:
    """The program of :func:`make_e2e_program` as a :class:`FastForward`
    over the pair ``(g_variables, r_variables)``: ``prepare`` prepares both
    legs once, ``run(prepared, z)`` is the chunk loop and the searches.
    ``export --what e2e`` traces ``run`` on prepared weights
    (cli/export.py). G and R may be None where ``g_apply`` and ``r_apply``
    are given."""
    g, r = _as_forward(g_apply, G), _as_forward(r_apply, R)
    g_then_r = _g_then_r_fn(g, r, pixel_k > 0)

    def prepare(variables):
        g_variables, r_variables = variables
        return g.prepare(g_variables), r.prepare(r_variables)

    def run(prepared, z):
        g_prepared, r_prepared = prepared
        out = forward_batched(
            lambda zc: g_then_r(g_prepared, r_prepared, zc), z, batch_size)
        if pixel_k > 0:
            emb, flat = out
            v, i = topk_all(emb, k, needle_chunk, approx, recall_target)
            pv, pi = topk_all(flat, pixel_k, needle_chunk, approx,
                              recall_target)
            return emb, v, i, pv, pi
        v, i = topk_all(out, k, needle_chunk, approx, recall_target)
        return out, v, i

    return FastForward(prepare, run)


def make_e2e_program(G: nn.Module, R: nn.Module, *, batch_size: int = 128,
                     k: int = 100, needle_chunk: int = 256,
                     g_apply: Optional[Callable] = None,
                     r_apply: Optional[Callable] = None,
                     approx: bool = False, recall_target: float = 0.95,
                     pixel_k: int = 0, capture: bool = True
                     ) -> CapturedProgram:
    """``run(g_variables, r_variables, z) -> (emb, v, i)``, or ``(emb, v,
    i, pv, pi)`` with ``pixel_k > 0``: chunks of ``batch_size`` latents
    through G then R, then the top-``k`` rows by cosine of every embedding
    (and the top-``pixel_k`` by cosine of the flat images), as in
    apply_r.lua:143-153 + 265-318 with every face a needle.

    ``g_apply(g_variables, z_chunk) -> images`` and ``r_apply(r_variables,
    images) -> embeddings`` override the module legs, e.g. the fast
    forwards of models/fastpath.py on the same variable trees; a
    ``FastForward`` is prepared once per call. ``approx`` selects both
    searches' top-k with kernel S at ``recall_target`` (JAX's
    ``approx_max_k``) instead of ``torch.topk``. On CUDA tensors ``run`` is
    one CUDA graph per (N, dtype) of its inputs (analysis/graphs.py);
    ``capture=False`` runs it eagerly, to time the graph against it."""
    forward = make_e2e_forward(G, R, batch_size=batch_size, k=k,
                               needle_chunk=needle_chunk, g_apply=g_apply,
                               r_apply=r_apply, approx=approx,
                               recall_target=recall_target, pixel_k=pixel_k)

    def program(g_variables, r_variables, z):
        return forward((g_variables, r_variables), z)

    return CapturedProgram(program, capture=capture)


def make_distributed_e2e_program(G: Optional[nn.Module],
                                 R: Optional[nn.Module], *, mesh,
                                 batch_size: int = 128, k: int = 100,
                                 needle_chunk: int = 256,
                                 g_apply: Optional[Callable] = None,
                                 r_apply: Optional[Callable] = None,
                                 approx: bool = False,
                                 recall_target: float = 0.95,
                                 pixel_k: int = 0, capture: bool = True):
    """The fused program of :func:`make_e2e_program` with z cut over the
    mesh's 'data' axis (JAX's ``make_distributed_e2e_program``, the
    north-star workload scaled out; apply_r.lua:143-153 + 265-318).

    ``run(g_variables, r_variables, z_local)`` takes this rank's rows of z
    (``mesh.rows(N)``, every rank as many) and returns the results of its
    rows in global numbering: ``(emb, v, i)``, or ``(emb, v, i, pv, pi)``
    with ``pixel_k > 0``.

    * Each rank runs the chunk loop (G then R, prepared once) on its rows:
      one CUDA graph on the card, as in :func:`make_e2e_program`.
    * One tiled all-gather brings every rank the whole (N, D) embedding
      corpus in row order (the embeddings as the chunk loop gives them:
      kernel C normalises, as in the one-rank search); each rank then
      searches its own rows as needles against it (:func:`topk_all` on
      ``rows``: kernel C, then ``torch.topk`` or kernel S), a second
      graph.
    * The pixel measure scores every row against all N flat images, a
      corpus about 125 times wider than the embeddings at the flagship
      shape: instead of gathering it, the flat-image blocks pass around a
      ``ppermute`` ring (n_shards steps). At each step a rank scores its
      rows against the visiting block with kernel C (on its rows with the
      block appended, the block's columns kept) and folds the candidates
      into a running top-``pixel_k`` (a third graph, the block's global
      offset an input). A rank holds at most two blocks.

    The collectives run between the graphs. Parameters are replicated
    (pure data parallelism); a mesh with a 'model' axis other than 1 is
    refused, as in JAX: analysis/distributed.py takes 'model'-sharded
    weights. Results equal the one-rank program's when (N / n_shards) %
    batch_size == 0 (the same chunk boundaries)."""
    if mesh.shape[MODEL_AXIS] != 1:
        raise ValueError(
            "make_distributed_e2e_program is the pure-DP north-star "
            f"pipeline; got model axis {mesh.shape[MODEL_AXIS]} != 1 — "
            "use analysis/distributed.py for TP-sharded params")
    n_shards = mesh.shape[DATA_AXIS]
    me = mesh.axis_index(DATA_AXIS)
    g, r = _as_forward(g_apply, G), _as_forward(r_apply, R)
    g_then_r = _g_then_r_fn(g, r, pixel_k > 0)

    def chunk_loop(g_variables, r_variables, z):
        g_prepared, r_prepared = g.prepare(g_variables), r.prepare(r_variables)
        return forward_batched(
            lambda zc: g_then_r(g_prepared, r_prepared, zc), z, batch_size)

    def search(corpus):
        local_n = corpus.shape[0] // n_shards
        return topk_all(corpus, k, needle_chunk, approx, recall_target,
                        rows=slice(me * local_n, (me + 1) * local_n))

    def ring_step(flat, block, vbest, ibest, offset):
        """Fold the top-k of ``flat``'s rows against ``block`` (global
        rows ``offset`` on) into the running (vbest, ibest)."""
        local_n = flat.shape[0]
        both = topk_kernel.padded_corpus(torch.cat([flat, block]))
        needles = torch.arange(local_n, device=flat.device)
        kk = min(pixel_k, block.shape[0])
        vs, ids = [], []
        for s in range(0, local_n, needle_chunk):
            scores = topk_kernel.cosine_scores(
                both, needles[s:s + needle_chunk])[:, local_n:]
            v, i = select_topk(scores, kk, approx, recall_target)
            vs.append(v)
            ids.append(i)
        vcat = torch.cat([vbest, torch.cat(vs)], dim=1)
        icat = torch.cat([ibest, torch.cat(ids) + offset], dim=1)
        vbest, sel = torch.topk(vcat, pixel_k, dim=1)
        return vbest, torch.gather(icat, 1, sel)

    legs = [CapturedProgram(fn, capture=capture)
            for fn in (chunk_loop, search, ring_step)]
    perm = [(s, (s + 1) % n_shards) for s in range(n_shards)]

    def run(g_variables, r_variables, z):
        out = legs[0](g_variables, r_variables, z)
        emb, flat = out if pixel_k > 0 else (out, None)
        v, i = legs[1](all_gather(emb, mesh, DATA_AXIS))
        if pixel_k == 0:
            return emb, v, i
        local_n = flat.shape[0]
        vbest = torch.full((local_n, pixel_k), float("-inf"),
                           device=flat.device)
        ibest = torch.zeros((local_n, pixel_k), dtype=torch.int64,
                            device=flat.device)
        block = flat
        for s in range(n_shards):
            # the visiting block started at shard (me - s) mod n_shards
            offset = torch.tensor((me - s) % n_shards * local_n,
                                  device=flat.device)
            vbest, ibest = legs[2](flat, block, vbest, ibest, offset)
            if s < n_shards - 1:
                block = ppermute(block, perm, mesh, DATA_AXIS)
        return emb, v, i, vbest, ibest

    return run


def make_serial_programs(G: nn.Module, R: nn.Module, *,
                         batch_size: int = 128, k: int = 100,
                         needle_chunk: int = 256,
                         g_apply: Optional[Callable] = None,
                         r_apply: Optional[Callable] = None):
    """The unfused pipeline as three programs, ``generate(g_variables, z)
    -> images``, ``invert(r_variables, images) -> emb`` and ``search(emb)
    -> (v, i)``, to measure what the fusion of :func:`make_e2e_program`
    buys. The legs and their overrides are the fused program's, so the
    two give the same embeddings on the same chunk boundaries; each
    program is captured the same way."""
    g, r = _as_forward(g_apply, G), _as_forward(r_apply, R)

    def generate(g_variables, z):
        prepared = g.prepare(g_variables)
        return forward_batched(lambda b: g.run(prepared, b), z, batch_size)

    def invert(r_variables, images):
        prepared = r.prepare(r_variables)
        return forward_batched(lambda b: r.run(prepared, b), images,
                               batch_size)

    def search(emb):
        return topk_all(emb, k, needle_chunk)

    return tuple(CapturedProgram(fn) for fn in (generate, invert, search))
