"""The fused generate→invert→top-k program, its search legs and
SimilarityIndex (ganreverser_tpu_torch/analysis/{e2e,similarity,batched}.py)
against the JAX package on the CPU: the same weights carried across by
models/bridge.py, the same numpy latents, the JAX side through its module
path (tests/test_analysis.py's cases). On CPU tensors the port's programs
run eagerly on the kernels' plain versions.

Tolerances, f32: top-k values rtol 1e-5 and atol 1e-6 (sums in another
order), indices equal (the inputs are random normal, and the kernels of G
and R are amplified so that no two images are near ties); the embeddings
of the module legs rtol 1e-4 and atol 1e-5 (eight layers of f32 sums in
XLA's order against PyTorch's: up to 1.8e-5 apart); the fast forwards
(BatchNorm folded, phase-aggregated upsampling) against JAX's modules
within 1e-4, as tests/test_torch_port_slice.py holds them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import analysis as JA
from ganreverser_tpu import models as M
from ganreverser_tpu_torch import analysis as TA
from ganreverser_tpu_torch.models import bridge, zoo

from torch_port_fixtures import one_thread  # noqa: F401

DIMS, ND, N = (1, 8, 8), 8, 24
BATCH, K, CHUNK, PIXEL_K = 8, 4, 8, 3
T = torch.from_numpy


def _close(port, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _close_emb(port, ref):
    _close(port, ref, rtol=1e-4, atol=1e-5)


def _same(port, ref):
    assert np.array_equal(np.asarray(port), np.asarray(ref))


def _variables(model, in_shape, seed, rng, amplify=4.0):
    """JAX variables with non-trivial BatchNorm statistics and the kernels
    scaled by ``amplify`` (random-init G and R give near-tied scores
    otherwise), as numpy."""
    v, _ = model.init(jax.random.PRNGKey(seed), in_shape)
    state = {layer: {"mean": (rng.normal(size=s["mean"].shape) * 0.1
                              ).astype(np.float32),
                     "var": rng.uniform(0.5, 1.5, s["var"].shape
                                        ).astype(np.float32)}
             for layer, s in v["state"].items()}
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(leaf) * (
            amplify if path[-1].key == "kernel" else 1.0), v["params"])
    return {"params": params, "state": state}


@pytest.fixture(scope="module")
def case():
    """JAX G and R, their variables, the latents, and the JAX programs'
    results with and without the pixel leg."""
    rng = np.random.default_rng(10)
    G, R = M.create_G(DIMS, ND), M.create_R(DIMS, ND, "normal")
    gv = _variables(G, (ND,), 1, rng)
    rv = _variables(R, DIMS[1:] + DIMS[:1], 2, rng)
    z = rng.normal(size=(N, ND)).astype(np.float32)
    runs = {p: JA.make_e2e_program(G, R, batch_size=BATCH, k=K,
                                   needle_chunk=CHUNK, pixel_k=p)(gv, rv, z)
            for p in (0, PIXEL_K)}
    return {"G": G, "R": R, "gv": gv, "rv": rv, "z": z, "jax": runs}


def _port(case):
    """The port's G and R modules and the variables as CPU tensors."""
    return (zoo.create_G3(DIMS, ND), zoo.create_R(DIMS, ND, "normal"),
            bridge.to_torch(case["gv"], "cpu"),
            bridge.to_torch(case["rv"], "cpu"), T(case["z"]))


def test_forward_batched_tuple_output(rng):
    """Tuple outputs are unchunked, as JAX unchunks pytrees (the fused
    program's chunks return embeddings and flat pixels)."""
    x = rng.normal(size=(20, 4)).astype(np.float32)
    a, b = TA.forward_batched(lambda c: (c * 2.0, c.sum(1)), T(x), 8)
    ja, jb = JA.forward_batched(lambda c: (c * 2.0, jnp.sum(c, axis=1)),
                                jnp.asarray(x), 8)
    _close(a, ja)
    _close(b, jb)
    assert a.shape == (20, 4) and b.shape == (20,)


@pytest.mark.parametrize("n,d,k,chunk", [(37, 16, 5, 8), (5, 16, 3, 16)])
def test_topk_all_matches_jax(rng, n, d, k, chunk):
    """Every row a needle, through kernel C's plain version per needle
    chunk: a ragged last chunk (37 rows, chunk 8) and a corpus smaller than
    half a chunk (5 rows, chunk 16)."""
    emb = rng.normal(size=(n, d)).astype(np.float32)
    v, i = TA.topk_all(T(emb), k, needle_chunk=chunk)
    jv, ji = JA.topk_all(jnp.asarray(emb), k, needle_chunk=chunk)
    _close(v, jv)
    _same(i, ji)
    assert v.shape == (n, k)


def test_chunked_topk_search_distinct_queries(rng):
    """Queries that are not corpus rows, zero-padded to whole chunks."""
    q = rng.normal(size=(11, 16)).astype(np.float32)
    c = rng.normal(size=(29, 16)).astype(np.float32)
    qn, cn = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (q, c))
    v, i = TA.chunked_topk_search(T(qn), T(cn), 4, needle_chunk=8)
    jv, ji = JA.chunked_topk_search(jnp.asarray(qn), jnp.asarray(cn), 4,
                                    needle_chunk=8)
    _close(v, jv)
    _same(i, ji)


@pytest.mark.parametrize("pixel_k", [0, PIXEL_K])
def test_e2e_program_matches_jax(case, pixel_k):
    """The module legs on the same weights and latents: embeddings, the
    top-k of every row and, with the pixel leg, the top-k by flat pixels."""
    G, R, gv, rv, z = _port(case)
    run = TA.make_e2e_program(G, R, batch_size=BATCH, k=K,
                              needle_chunk=CHUNK, pixel_k=pixel_k)
    out = run(gv, rv, z)
    ref = case["jax"][pixel_k]
    assert len(out) == len(ref) == (5 if pixel_k else 3)
    _close_emb(out[0], ref[0])
    for j, (a, b) in enumerate(zip(out[1:], ref[1:]), 1):
        (_same if j in (2, 4) else _close)(a, b)  # indices, values


@pytest.mark.parametrize("pixel_k", [0, PIXEL_K])
def test_e2e_program_fast_overrides_match_jax(case, pixel_k):
    """g_apply/r_apply: the port's fast G (kernel U and U's fused head)
    and R (kernel B), their plain versions on the CPU,
    prepared once per call, against JAX's module program within 1e-4; the
    rankings equal."""
    G, R, gv, rv, z = _port(case)
    run = TA.make_e2e_program(
        G, R, batch_size=BATCH, k=K, needle_chunk=CHUNK, pixel_k=pixel_k,
        **TA.e2e.fast_legs(DIMS, ND, "normal", torch.float32))
    out = run(gv, rv, z)
    for j, (a, b) in enumerate(zip(out, case["jax"][pixel_k])):
        if j in (2, 4):
            _same(a, b)
        else:
            _close(a, b, rtol=1e-4, atol=1e-4)


def test_serial_programs_match_fused(case):
    """generate-all, invert-all, search-all give the fused program's
    results bitwise (same legs, same chunk boundaries), and JAX's serial
    programs' within the tolerance."""
    G, R, gv, rv, z = _port(case)
    kw = dict(batch_size=BATCH, k=K, needle_chunk=CHUNK)
    generate, invert, search = TA.make_serial_programs(G, R, **kw)
    images = generate(gv, z)
    emb = invert(rv, images)
    v, i = search(emb)
    fused = TA.make_e2e_program(G, R, **kw)(gv, rv, z)
    for a, b in zip((emb, v, i), fused):
        assert torch.equal(a, b)
    jg, ji, js = JA.make_serial_programs(case["G"], case["R"], **kw)
    jimages = jg(case["gv"], case["z"])
    _close_emb(images, jimages)
    jemb = ji(case["rv"], jimages)
    jv, jidx = js(jemb)
    _close_emb(emb, jemb)
    _close(v, jv)
    _same(i, jidx)


def test_similarity_index_matches_jax(rng):
    """size, topk_by_index (kernel C's plain version on the stored rows)
    and topk of free queries against the JAX index."""
    emb = rng.normal(size=(64, 16)).astype(np.float32)
    queries = rng.normal(size=(5, 16)).astype(np.float32)
    needles = np.array([0, 7, 63])
    index, jindex = TA.SimilarityIndex(T(emb)), JA.SimilarityIndex(emb)
    assert index.size == jindex.size == 64
    v, i = index.topk_by_index(T(needles), 6)
    jv, ji = jindex.topk_by_index(jnp.asarray(needles), 6)
    _close(v, jv)
    _same(i, ji)
    v, i = index.topk(T(queries), 6)
    jv, ji = jindex.topk(jnp.asarray(queries), 6)
    _close(v, jv)
    _same(i, ji)


def _approx_index(rng, case, by_index):
    """SimilarityIndex with approx=True at 64 rows and k = 6, where the
    plan's bins are the rows (exact on both sides)."""
    emb = rng.normal(size=(64, 16)).astype(np.float32)
    index, jindex = TA.SimilarityIndex(T(emb)), JA.SimilarityIndex(emb)
    if by_index:
        needles = np.array([0, 7, 63])
        return (index.topk_by_index(T(needles), 6, approx=True),
                jindex.topk_by_index(jnp.asarray(needles), 6, approx=True))
    queries = rng.normal(size=(5, 16)).astype(np.float32)
    return (index.topk(T(queries), 6, approx=True, recall_target=0.95),
            jindex.topk(jnp.asarray(queries), 6, approx=True,
                        recall_target=0.95))


def _approx_topk_all(rng, case):
    emb = rng.normal(size=(37, 16)).astype(np.float32)
    return (TA.topk_all(T(emb), 5, 8, True, 0.95),
            JA.topk_all(jnp.asarray(emb), 5, 8, True, 0.95))


def _approx_program(rng, case):
    """The fused program with approx=True and the pixel leg: N = 24 rows,
    k = 4 and pixel_k = 3 at recall 0.95 take 24 bins."""
    G, R, gv, rv, z = _port(case)
    out = TA.make_e2e_program(G, R, batch_size=BATCH, k=K,
                              needle_chunk=CHUNK, approx=True,
                              recall_target=0.95, pixel_k=PIXEL_K)(gv, rv, z)
    ref = JA.make_e2e_program(case["G"], case["R"], batch_size=BATCH, k=K,
                              needle_chunk=CHUNK, approx=True,
                              recall_target=0.95, pixel_k=PIXEL_K)(
        case["gv"], case["rv"], case["z"])
    _close_emb(out[0], ref[0])
    return out[1:], ref[1:]


@pytest.mark.parametrize("call", [
    lambda rng, case: _approx_index(rng, case, False),
    lambda rng, case: _approx_index(rng, case, True),
    _approx_topk_all, _approx_program,
], ids=["topk", "topk_by_index", "topk_all", "make_e2e_program"])
def test_approx_matches_jax(rng, case, call):
    """approx=True through the port's search entry points against JAX's
    approx=True on the same inputs, where the plan's bin count is the
    row count: the selection is exact on both sides (approx_max_k is exact
    on the CPU), so values within the tolerance and indices equal."""
    out, ref = call(rng, case)
    assert len(out) == len(ref)
    for j, (a, b) in enumerate(zip(out, ref)):
        (_same if j % 2 else _close)(a, b)  # values, indices
        if j % 2:
            assert a.dtype == torch.int64
