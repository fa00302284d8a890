"""Approximate top-k selection (kernel S's plain version,
ganreverser_tpu_torch/ops/approx_topk_kernel.py), the search entry points'
``approx=True`` and the two-pass tiled_topk (ops/tiled_topk.py) against the
JAX package on the CPU, inputs from numpy with fixed seeds.

``jax.lax.approx_max_k`` is exact on the CPU, so JAX's ``approx=True`` is
its exact selection. Where the plan's bin count L is the row count N the
port's selection is exact too: values within rtol 1e-5 and atol 1e-6
(kernel C's plain version sums in another order than XLA), indices
equal. Where L < N the port's answer is approximate and held to JAX's by
recall, as JAX's own guard holds its TPU answer (tests/test_analysis.py):
at least recall_target - 0.02. The plain version against a numpy
transcription of the rule: bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import analysis as JA
from ganreverser_tpu.ops.tiled_topk import pixel_cosine_topk_tiled as j_pixel
from ganreverser_tpu.ops.tiled_topk import tiled_topk as j_tiled
from ganreverser_tpu_torch import analysis as TA
from ganreverser_tpu_torch.ops import approx_topk_kernel as S
from ganreverser_tpu_torch.ops import topk_kernel

from torch_port_fixtures import one_thread  # noqa: F401

T = torch.from_numpy


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _same(port, ref):
    assert np.array_equal(np.asarray(port), np.asarray(ref))


@pytest.mark.parametrize("q,n,k,r,bins,cluster,keys_on_chip,stage_row", [
    (10, 10_000, 100, 0.95, 1024, 1, True, True),     # apply_r's searches
    (256, 10_240, 100, 0.95, 1024, 1, True, True),    # the e2e needle chunk
    (256, 10_240, 100, 0.99, 8192, 1, True, True),    # 105 KB a block
    (10, 4096, 50, 0.95, 512, 1, True, True),
    (10, 10_000, 100, 1.0, 10_000, 8, True, False),   # a cluster a row
    (2, 16_384, 100, 1.0, 16_384, 8, True, False),
    (256, 16_385, 100, 1.0, 16_385, 1, True, False),  # 131 KB of keys
    (256, 100_000, 100, 0.999, 65_536, 1, False, False),
    (3, 24, 4, 0.95, 24, 1, True, False),             # L = N
    (1, 1000, 1, 0.5, 1, 1, True, True),
    (1, 1000, 1000, 0.5, 1000, 1, True, False),       # L >= k
    (10, 10_240, 100, 1.0, 10_240, 8, True, False),   # apply_r's Q, e2e's N
    (256, 10_000, 100, 1.0, 10_000, 1, True, False),  # the e2e chunk's Q
    (40, 10_000, 100, 1.0, 10_000, 2, True, False),   # 80 blocks, not 160
    (256, 20_480, 100, 1.0, 20_480, 1, True, False),  # the large-L shape
    (256, 30_000, 100, 1.0, 30_000, 1, False, False),  # past a block's memory
    (1, 100_000, 100, 1.0, 100_000, 8, True, False),  # ... not the cluster's
    (10, 10_000, 100, 0.99, 8192, 8, True, False),    # apply_r at r = 0.99
    (256, 40_000, 100, 0.99, 8192, 1, True, False),   # two such blocks exceed
])
def test_approx_plan(q, n, k, r, bins, cluster, keys_on_chip, stage_row):
    """L is the least power of two >= k reaching the recall estimate,
    capped at N (r = 1 gives N); the cluster doubles while the rows'
    blocks fit the SMs and each owns MIN_CLUSTER_BINS bins; the keys stay
    on chip while a block's share of them fits beside the k survivors; one
    block a row stages its row where bins hold several elements and two
    blocks still fit an SM."""
    assert S.approx_plan(n, k, r) == bins
    plan = S.select_plan(q, n, k, r)
    per = -(-bins // cluster)
    assert plan == (bins, cluster, keys_on_chip, True, stage_row,
                    8 * k + 8 * per * keys_on_chip + 16 * -(-n // 4)
                    * stage_row)
    assert plan.smem + S.SMEM_FIXED <= S.SMEM_LIMIT
    if bins < n:
        assert 1 - (k - 1) / (2 * bins) >= r
    if bins < n and bins > 1 << (k - 1).bit_length():  # the least such
        assert r > 1 - (k - 1) / bins


def test_approx_plan_sorts_in_the_output_past_shared_memory():
    """k keys that do not fit one block's shared memory are sorted in the
    row's indices output; the keys stay on chip beside nothing else."""
    plan = S.select_plan(1, 40_000, 30_000, 1.0)
    assert plan == (40_000, 8, True, False, False, 8 * 5000)
    assert S.select_plan(2, 20_000, 17_000, 1.0) == (
        20_000, 8, True, True, False, 8 * 17_000 + 8 * 2500)


@pytest.mark.parametrize("n,k,r", [(10, 11, 0.9), (10, 0, 0.9), (10, 3, 0.0),
                                   (10, 3, 1.5)])
def test_approx_plan_refuses(n, k, r):
    with pytest.raises(ValueError):
        S.approx_plan(n, k, r)


def _rule(x: np.ndarray, k: int, bins: int):
    """The rule written out: bin j mod L keeps its largest value (a tie to
    the lower j), the candidates ranked by value descending (a tie to the
    lower j), the first k."""
    vs, ids = [], []
    for row in x:
        best = {}
        for j, v in enumerate(row):
            b = j % bins
            if b not in best or v > row[best[b]]:
                best[b] = j
        order = sorted(best.values(), key=lambda j: (-row[j], j))[:k]
        ids.append(order)
        vs.append(row[order])
    return np.array(vs, np.float32), np.array(ids, np.int64)


@pytest.mark.parametrize("q,n,k,r", [(4, 1000, 20, 0.95), (3, 300, 7, 1.0),
                                     (3, 777, 5, 0.99), (2, 64, 64, 0.5)])
def test_approx_topk_plain_is_the_rule(q, n, k, r):
    """Bitwise, on data with planted ties: repeated values in and across
    bins, -0.0 beside +0.0, -inf."""
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(q, n)).astype(np.float32)
    x[:, ::7] = x[:, 3:4]
    x[:, 1::11] = np.float32(2.5)
    x[0, :4] = [-0.0, 0.0, -np.inf, 0.0]
    x[-1, ::2] = -np.inf
    v, i = S.approx_topk_plain(T(x), k, r)
    rv, ri = _rule(x, k, S.approx_plan(n, k, r))
    assert v.dtype == torch.float32 and i.dtype == torch.int64
    _same(i, ri)
    assert np.array_equal(v.numpy().view(np.uint32), rv.view(np.uint32))


def test_approx_topk_wrapper_runs_plain_on_cpu():
    """On a CPU tensor the operator runs the plain version; no launch."""
    x = torch.randn(5, 300, generator=torch.Generator().manual_seed(0))
    before = S.approx_topk.launches
    for a, b in zip(S.approx_topk(x, 10, 0.9), S.approx_topk_plain(x, 10,
                                                                    0.9)):
        assert torch.equal(a, b)
    assert S.approx_topk.launches == before
    with pytest.raises(ValueError):
        S.approx_topk(torch.zeros(2, 8, device="meta"), 2)


def test_searches_at_l_equal_n_match_jax():
    """L = N: cosine_topk, pixel_cosine_topk and chunked_topk_search with
    approx=True give JAX's approx=True results."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(64, 16)).astype(np.float32)
    images = rng.uniform(size=(64, 4, 4, 3)).astype(np.float32)
    needles = np.array([0, 9, 63])
    for port, ref in (
            (TA.cosine_topk(T(emb), T(needles), 6, True, 0.95),
             JA.cosine_topk(jnp.asarray(emb), jnp.asarray(needles), 6, True,
                            0.95)),
            (TA.pixel_cosine_topk(T(images), T(needles), 6, True, 0.95),
             JA.pixel_cosine_topk(jnp.asarray(images), jnp.asarray(needles),
                                  6, True, 0.95))):
        _close(port[0], ref[0])
        _same(port[1], ref[1])
    qn = emb[:11] / np.linalg.norm(emb[:11], axis=1, keepdims=True)
    cn = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    v, i = TA.chunked_topk_search(T(qn), T(cn), 6, 8, True, 0.95)
    jv, ji = JA.chunked_topk_search(jnp.asarray(qn), jnp.asarray(cn), 6, 8,
                                    True, 0.95)
    _close(v, jv)
    _same(i, ji)


def test_approx_recall_against_jax_below_l_equal_n():
    """N = 4,096, k = 50 at recall 0.95 takes 512 bins: the recall of the
    port's approximate top-k against JAX's reaches 0.93, its values are
    the scores at its indices, descending."""
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(4096, 16)).astype(np.float32)
    needles = np.arange(0, 4096, 128)
    assert S.approx_plan(4096, 50, 0.95) == 512
    v, i = TA.cosine_topk(T(emb), T(needles), 50, True, 0.95)
    _, ji = JA.cosine_topk(jnp.asarray(emb), jnp.asarray(needles), 50, True,
                           0.95)
    recall = TA.topk_recall(np.asarray(ji), i.numpy())
    assert recall >= 0.93, recall
    assert recall < 1.0  # the selection is approximate here
    scores = topk_kernel.cosine_scores(T(emb), T(needles))
    assert torch.equal(v, scores.gather(1, i))
    assert bool((v[:, :-1] >= v[:, 1:]).all())


@pytest.mark.parametrize("q,n,k,tile", [(8, 1000, 20, 128), (3, 50, 20, 16),
                                        (2, 300, 5, 2048)])
def test_tiled_topk_matches_jax(q, n, k, tile):
    """The two-pass selection: a ragged last tile (1,000 = 7 x 128 + 104),
    k above the tile (its survivors are whole tiles), one tile wider than
    N."""
    x = np.random.default_rng(q * n).normal(size=(q, n)).astype(np.float32)
    v, i = TA.tiled_topk(T(x), k, tile)
    jv, ji = j_tiled(jnp.asarray(x), k, tile)
    _same(v, jv)
    _same(i, ji)
    assert i.dtype == torch.int64


def test_pixel_cosine_topk_tiled_matches_jax():
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(100, 4, 4, 3)).astype(np.float32)
    needles = np.array([0, 17, 99])
    v, i = TA.pixel_cosine_topk_tiled(T(images), T(needles), 10, tile=16)
    jv, ji = j_pixel(jnp.asarray(images), jnp.asarray(needles), 10,
                     tile=16)
    _close(v, jv)
    _same(i, ji)
