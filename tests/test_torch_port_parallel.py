"""The port's distribution layer (ganreverser_tpu_torch/parallel) and the
sharded analysis on it (analysis/distributed.py,
analysis/e2e.py::make_distributed_e2e_program) against the JAX package on
the CPU.

The port's ranks are processes in a gloo world on the CPU (2 and 4 of
them, tests/torch_port_dist_worker.py, which imports no jax); each group
runs all its cases in one start-up. JAX runs its mesh on the eight fake
CPU devices of tests/conftest.py. A rank's results are its rows, gathered
here to compare with JAX's global arrays.

Tolerances: f32 top-k values rtol 1e-5, atol 1e-6 (sums in another
order), indices equal where the embeddings are separated (random normal
rows, or tests/test_distributed_analysis.py::_separated_pipeline's
stand-in), the separated program's embeddings too (torch's and XLA's f32
tanh differ by an ulp or so); the port's
distributed results against its one-rank functions on the same latents
1e-5 relative (the same kernels on the same chunks: equal in practice);
the fast G and R against JAX's module path rtol 1e-4, atol 1e-5 (as in
tests/test_torch_port_e2e.py: BN folded, eight layers of f32 sums in
another order); approx=True held by its recall (at least r - 0.02)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import analysis as JA
from ganreverser_tpu import models as M
from ganreverser_tpu import parallel as jpar
from ganreverser_tpu.analysis.distributed import \
    distributed_cosine_topk as j_dist_topk
from ganreverser_tpu_torch import parallel as par
from ganreverser_tpu_torch.analysis import e2e
from ganreverser_tpu_torch.analysis.pipeline import generate_and_invert
from ganreverser_tpu_torch.analysis.similarity import (cosine_topk,
                                                       topk_recall)
from ganreverser_tpu_torch.models import bridge, zoo
from ganreverser_tpu_torch.ops import dropout_kernel as dk

import torch_port_dist_worker as W
from torch_port_fixtures import one_thread  # noqa: F401

DIMS, ND, N, BATCH = (1, 8, 8), 8, 64, 16
N_FAST, K = 32, 10
T = torch.from_numpy


def _amplified(model, in_shape, seed, rng, amplify=4.0):
    """JAX variables with non-trivial BN statistics and the kernels scaled
    by ``amplify`` (random-init G and R give near-tied scores otherwise)."""
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
    rng = np.random.default_rng(14)
    G, R = M.create_G(DIMS, ND), M.create_R(DIMS, ND, "normal")
    RF = M.create_R(DIMS, ND, "normal", fixer=True)
    hwc = DIMS[1:] + DIMS[:1]
    gv, rv = _amplified(G, (ND,), 1, rng), _amplified(R, hwc, 2, rng)
    rfv = _amplified(RF, hwc, 3, rng)
    inputs = {"dims": np.array(DIMS), "nd": np.array(ND), "n": np.array(N),
              "seed": np.array(3), "batch": np.array(BATCH),
              "emb": rng.normal(size=(N, 32)).astype(np.float32),
              "needles": np.array([0, 33, 63]), "k": np.array(K),
              "scores": rng.normal(size=(N,)).astype(np.float32),
              # tests/test_distributed_analysis.py::_separated_pipeline's W
              "sep_w": np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                                    (ND, 16))),
              "z_sep": rng.normal(size=(N, ND)).astype(np.float32),
              "z_fast": rng.normal(size=(N_FAST, ND)).astype(np.float32),
              "batch_e2e": np.array(8),
              "drop_x": rng.normal(size=(8, 5, 3)).astype(np.float32),
              "drop_seed": np.array(-1234567)}
    for key, v in (("gv", gv), ("rv", rv), ("rfv", rfv)):
        inputs.update(W.flat(v, key + "/"))
    return {"G": G, "R": R, "gv": gv, "rv": rv, "rfv": rfv,
            "inputs": inputs}


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """world -> each rank's results: 2 ranks and 4 ranks, every case in
    one start-up each."""
    cases = ["comm", "mesh", "analysis", "analysis_tp", "e2e",
             "dropout_base"]
    return {world: W.run_ranks(str(tmp_path_factory.mktemp(f"w{world}")),
                               world, cases, case["inputs"])
            for world in (2, 4)}


def _gather(results, key):
    """The ranks' rows of ``key``, in rank order, one copy per data index
    (ranks of one 'model' group hold the same rows)."""
    model = int(results[0]["mesh/shape_m2"][1]) if "tp" in key else 1
    return np.concatenate([r[key] for r in results[::model]])


def _close(port, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("data,model", [(0, 1), (4, 2), (2, 2), (8, 1),
                                        (1, 1), (0, 2), (0, 8)])
def test_mesh_shapes_match_jax(data, model):
    """The port's mesh rules on 8 devices give JAX's make_mesh shapes on
    the 8 fake CPU devices."""
    jm = jpar.make_mesh(data=data, model=model)
    assert par.mesh_shape(data, model, 8) == (jm.shape["data"],
                                              jm.shape["model"])


@pytest.mark.parametrize("data,model", [(0, 9), (3, 3), (9, 1), (5, 2)])
def test_mesh_refusals_match_jax(data, model):
    with pytest.raises(ValueError) as jerr:
        jpar.make_mesh(data=data, model=model)
    with pytest.raises(ValueError) as perr:
        par.mesh_shape(data, model, 8)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("net", ["G3", "R", "D2", "R_fixer"])
def test_param_partition_spec_matches_jax(net):
    """Every leaf of G3, R and D2 at 3x32x32 (noise 100), at model sizes 1,
    2, 3 and 4 and the default and a small min_size."""
    dims = (3, 32, 32)
    model = {"G3": lambda: M.create_G(dims, 100),
             "R": lambda: M.create_R(dims, 100, "normal"),
             "R_fixer": lambda: M.create_R(dims, 100, "normal", fixer=True),
             "D2": lambda: M.create_D(dims)}[net]()
    in_shape = (100,) if net == "G3" else dims[1:] + dims[:1]
    leaves = jax.tree_util.tree_leaves(model.init(
        jax.random.PRNGKey(0), in_shape)[0]["params"])
    sharded = 0
    for leaf in leaves:
        for m in (1, 2, 3, 4):
            for min_size in (1 << 16, 1 << 10):
                spec = par.param_partition_spec(leaf, min_size, m)
                assert spec.axes == tuple(jpar.param_partition_spec(
                    leaf, min_size, m))
                sharded += spec.dim("model") is not None
    assert sharded > 0


def test_param_partition_spec_on_tensors():
    """The rule reads a torch tensor's shape as JAX reads an array's."""
    for shape in [(512, 512), (3, 3, 64, 128), (100, 8192), (5,)]:
        t = torch.zeros(shape)
        for m in (1, 2, 4):
            assert par.param_partition_spec(t, 1 << 10, m).axes == tuple(
                jpar.param_partition_spec(np.zeros(shape), 1 << 10, m))


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_in_a_world(ranks, world):
    res = ranks[world]
    for r, out in enumerate(res):
        assert list(out["mesh/shape"]) == [world, 1]
        assert list(out["mesh/rows"]) == [r * 8 // world,
                                          (r + 1) * 8 // world]
        assert list(out["mesh/shape_m2"]) == [world // 2, 2]
        assert list(out["mesh/index_m2"]) == [r // 2, r % 2]
        d, m = divmod(r, 2)
        assert list(out["mesh/ranks_m2"]) == (
            [i * 2 + m for i in range(world // 2)] + [d * 2, d * 2 + 1])
        assert str(out["mesh/err_too_big"]) == (
            f"mesh ({world + 1} data x 1 model) does not fit {world} devices")
        assert str(out["mesh/err_model_big"]) == (
            f"model axis {world + 1} exceeds the {world} available devices")
        assert str(out["mesh/err_too_small"]) == (
            f"mesh (1 data x 1 model) leaves {world - 1} of the {world} "
            "ranks out")


@pytest.mark.parametrize("world", [2, 4])
def test_collectives(ranks, world):
    """psum, pmean, tiled and stacked all_gather, a ppermute ring and a
    one-pair permutation (the others get zeros), a psum of a tree of two
    dtypes, broadcast, and psum's gradient (the sum over ranks)."""
    res = ranks[world]
    total = world * (world + 1) / 2
    for r, out in enumerate(res):
        _close(out["comm/psum"], np.full(3, total))
        _close(out["comm/pmean"], np.full(3, total / world))
        want = np.repeat(np.arange(1, world + 1, dtype=np.float32), 3)
        _close(out["comm/gather"].ravel(), want)
        _close(out["comm/gather_axis1"].ravel(), want)
        _close(out["comm/stack"].ravel(), want)
        assert out["comm/stack"].shape == (world, 3)
        _close(out["comm/ring"], np.full(3, (r - 1) % world + 1.0))
        _close(out["comm/partial"], np.full(3, 1.0 if r == world - 1
                                            else 0.0))
        _close(out["comm/tree_f"], np.full(3, total))
        assert out["comm/tree_i"].dtype == np.int32
        assert int(out["comm/tree_i"][0]) == world * (world - 1) // 2
        _close(out["comm/bcast"], np.ones(3))
        _close(out["comm/psum_grad"], np.full(2, world * (r + 1.0)))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_topk_merge(case, ranks, world):
    """Against JAX's sharded_topk_merge on a mesh of as many devices and
    jax.lax.top_k of the whole vector."""
    scores = case["inputs"]["scores"]
    mesh = jpar.make_mesh(data=world)
    jv, ji = jpar.sharded_topk_merge(jpar.shard_batch(jnp.asarray(scores),
                                                      mesh), 5, mesh)
    rv, ri = jax.lax.top_k(jnp.asarray(scores), 5)
    for out in ranks[world]:
        _close(out["comm/merge_v"], jv)
        assert np.array_equal(out["comm/merge_i"], np.asarray(ji))
        assert np.array_equal(out["comm/merge_i"], np.asarray(ri))


@pytest.mark.parametrize("world,kind", [(2, "analysis"), (2, "analysis_tp"),
                                        (4, "analysis"), (4, "analysis_tp")])
def test_distributed_generate_and_invert(case, ranks, world, kind):
    """Each rank's rows of stage ②, with the fixer-R: the port's one-rank
    generate_and_invert on the same generators gives the gathered rows
    (the noise drawn whole on every rank, the fixer's masks the one-rank
    run's rows); JAX's module path on the same noise within the fast
    path's tolerance. With a 'model' axis (weights cut, min_size 2^10)
    at least one leaf of each net is sharded."""
    res = ranks[world]
    noise, images, attrs, attrs_f = (_gather(res, f"{kind}/{k}") for k in
                                     ("noise", "images", "attrs", "attrs_f"))
    to = lambda v: bridge.to_torch(v, "cpu")  # noqa: E731
    one = generate_and_invert(
        to(case["gv"]), to(case["rv"]), dims=DIMS, n=N, noise_dim=ND,
        noise_method="normal", generator=torch.Generator().manual_seed(3),
        batch_size=BATCH, rf_variables=to(case["rfv"]),
        fixer_generator=torch.Generator().manual_seed(4))
    for port, ref in zip((noise, images, attrs, attrs_f), one):
        _close(port, ref.numpy())
    j_images, _ = case["G"].apply(case["gv"], jnp.asarray(noise))
    j_attrs, _ = case["R"].apply(case["rv"], j_images)
    _close(images, j_images, rtol=1e-4, atol=1e-5)
    _close(attrs, j_attrs, rtol=1e-4, atol=1e-5)
    if kind == "analysis_tp":
        assert all(int(c) > 0 for c in res[0][f"{kind}/sharded_leaves"])
    # the search over the ranks' latents against the one-rank search
    tv, ti = cosine_topk(T(attrs), torch.arange(3), 10)
    for out in res:
        _close(out[f"{kind}/tv"], tv.numpy())


@pytest.mark.parametrize("world,kind", [(2, "analysis"), (2, "analysis_tp"),
                                        (4, "analysis"), (4, "analysis_tp")])
def test_distributed_cosine_topk(case, ranks, world, kind):
    """Exact: JAX's distributed_cosine_topk on a mesh of as many devices
    and its single-device cosine_topk, values and indices, on every rank.
    approx=True (kernel S's plain version per shard, r 0.9): recall
    against the exact result at least 0.88, each value the exact cosine of
    its index, descending."""
    inp = case["inputs"]
    emb, needles = jnp.asarray(inp["emb"]), jnp.asarray(inp["needles"])
    data = world // (2 if kind == "analysis_tp" else 1)
    model = world // data
    mesh = jpar.make_mesh(data=data, model=model)
    jv, ji = j_dist_topk(jpar.shard_batch(emb, mesh), needles, K, mesh)
    sv, si = JA.cosine_topk(emb, needles, K)
    exact = np.asarray(JA.cosine_scores(emb, needles))
    for out in ranks[world]:
        for ref_v, ref_i in ((jv, ji), (sv, si)):
            _close(out[f"{kind}/v"], ref_v)
            assert np.array_equal(out[f"{kind}/i"], np.asarray(ref_i))
        av, ai = out[f"{kind}/av"], out[f"{kind}/ai"]
        assert topk_recall(np.asarray(si), ai) >= 0.9 - 0.02
        _close(av, np.take_along_axis(exact, ai, 1))
        assert np.all(np.diff(av, axis=1) <= 0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("pixel_k", [0, 3])
def test_distributed_e2e_matches_jax(case, ranks, world, pixel_k):
    """The separated stand-in (g = tanh(z W), R = flatten) through the
    port's distributed program: embeddings, top-k values and indices of
    both measures (the ring's too) equal JAX's distributed program on a
    mesh of as many devices and its single-device program."""
    inp = case["inputs"]
    w = jnp.asarray(inp["sep_w"])

    def g_apply(_gv, zc):
        return jnp.tanh(zc @ w).reshape(zc.shape[0], 4, 4, 1)

    r_apply = lambda _rv, x: x.reshape(x.shape[0], -1)  # noqa: E731
    kw = dict(batch_size=8, k=4, needle_chunk=8, g_apply=g_apply,
              r_apply=r_apply, pixel_k=pixel_k)
    z = jnp.asarray(inp["z_sep"])
    single = JA.make_e2e_program(None, None, **kw)({}, {}, z)
    mesh = jpar.make_mesh(data=world)
    dist = JA.make_distributed_e2e_program(None, None, mesh=mesh, **kw)(
        {}, {}, jpar.shard_batch(z, mesh))
    names = ("emb", "v", "i", "pv", "pi")[:len(single)]
    for name, s_ref, d_ref in zip(names, single, dist):
        port = _gather(ranks[world], f"e2e/sep{pixel_k}_{name}")
        for ref in (s_ref, d_ref):
            if name in ("i", "pi"):
                assert np.array_equal(port, np.asarray(ref)), name
            else:
                _close(port, ref)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_e2e_fast_legs(case, ranks, world):
    """The fast G (kernel U's plain version) and R (kernel B's) through
    the distributed program with the pixel ring: the gathered rows equal
    the port's one-rank fused program on the same latents, and the
    embeddings JAX's module path within the fast path's tolerance."""
    to = lambda v: bridge.to_torch(v, "cpu")  # noqa: E731
    z = case["inputs"]["z_fast"]
    legs = e2e.fast_legs(DIMS, ND, "normal", torch.float32)
    one = e2e.make_e2e_program(None, None, batch_size=8, k=4, needle_chunk=8,
                               pixel_k=3, **legs)(to(case["gv"]),
                                                  to(case["rv"]), T(z))
    for name, ref in zip(("emb", "v", "i", "pv", "pi"), one):
        port = _gather(ranks[world], f"e2e/fast_{name}")
        if name in ("i", "pi"):  # ties of a random G: same shape only
            assert port.shape == tuple(ref.shape)
        else:
            _close(port, ref.numpy())
    j_images, _ = case["G"].apply(case["gv"], jnp.asarray(z))
    j_emb, _ = case["R"].apply(case["rv"], j_images)
    _close(_gather(ranks[world], "e2e/fast_emb"), j_emb, 1e-4, 1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_e2e_refuses_model_axis(ranks, world):
    """A mesh with a 'model' axis is refused with JAX's message."""
    with pytest.raises(ValueError) as jerr:
        JA.make_distributed_e2e_program(
            None, None, mesh=jpar.make_mesh(data=world // 2, model=2))
    for out in ranks[world]:
        assert str(out["e2e/err_model"]) == str(jerr.value)


def test_distributed_e2e_one_rank_without_a_group():
    """Without a process group the world is one rank: the distributed
    program is the fused program, bit for bit, on random G3 and R."""
    g = torch.Generator().manual_seed(0)
    from ganreverser_tpu_torch.models import modules
    G = modules.init_parameters(zoo.create_G3(DIMS, ND), g)
    R = modules.init_parameters(zoo.create_R(DIMS, ND, "normal"), g)
    legs = e2e.fast_legs(DIMS, ND, "normal", torch.float32)
    kw = dict(batch_size=8, k=4, needle_chunk=8, pixel_k=3, **legs)
    gv, rv = bridge.module_variables(G), bridge.module_variables(R)
    z = torch.randn(24, ND, generator=g)
    one = e2e.make_e2e_program(G, R, **kw)(gv, rv, z)
    dist = e2e.make_distributed_e2e_program(
        G, R, mesh=par.make_mesh(), **kw)(gv, rv, z)
    for a, b in zip(one[:4], dist[:4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_dropout_counter_base_per_rank(ranks, world):
    """Each rank's rows of a batch through kernel B5's plain version with
    the counter base of its first row: bitwise the rows of the whole
    batch's mask."""
    for out in ranks[world]:
        assert np.array_equal(out["dropout_base/part"],
                              out["dropout_base/whole_rows"])


@pytest.mark.parametrize("shape,parts", [((8, 5, 3), 2), ((12, 7), 3),
                                         ((16, 4, 4, 2), 4), ((6, 1), 6)])
@pytest.mark.parametrize("seed", [0, -7, 2 ** 31 - 1])
def test_dropout_counter_base(shape, parts, seed):
    """B5's plain version at a counter base: every part of a batch cut by
    rows gives bitwise the whole batch's rows, forward and backward; at
    base 0 the mask is unchanged; a base past 2^32 wraps as the index
    does."""
    g = torch.Generator().manual_seed(abs(seed))
    x = torch.randn(shape, generator=g, requires_grad=True)
    s = torch.tensor([seed], dtype=torch.int32)
    whole = dk.fused_dropout(x, s, 0.5)
    whole.sum().backward()
    row = x[0].numel()
    for p, rows in enumerate(torch.arange(shape[0]).chunk(parts)):
        lo = int(rows[0])
        xp = x.detach()[lo:lo + len(rows)].clone().requires_grad_(True)
        yp = dk.fused_dropout(xp, s, 0.5, base=lo * row)
        assert torch.equal(yp, whole[lo:lo + len(rows)])
        yp.sum().backward()
        assert torch.equal(xp.grad, x.grad[lo:lo + len(rows)])
    assert torch.equal(dk.fused_dropout(x, s, 0.5, base=0), whole)
    big = dk.fused_dropout(x.detach(), s, 0.5, base=1 << 32)
    assert torch.equal(big, whole.detach())
    with pytest.raises(ValueError):
        dk.fused_dropout(x, s, 0.5, base=-1)


@pytest.mark.parametrize("device,local,cards,backend", [
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 8, "nccl"), ("cuda", 2, 1, "gloo"),
    ("cuda", 8, 4, "gloo"), ("cpu", 2, 0, "gloo"), ("cpu", 1, 0, "gloo")])
def test_choose_backend(device, local, cards, backend):
    """NCCL only when every rank of the host has a card of its own."""
    assert par.choose_backend(device, local, cards) == backend


def test_one_process_helpers(monkeypatch):
    """Without a process group: one rank, the identity slices and
    collectives, JAX's layouts and messages (against JAX's own functions
    on a mesh of one device), and initialize_distributed a no-op without a
    coordinator or torchrun's environment; a bad count is JAX's error."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert not par.initialize_distributed()
    with pytest.raises(ValueError) as e:
        par.initialize_distributed("localhost:1", 0, -1)
    assert str(e.value) == ("--coordinator_address needs --num_processes > "
                            "0 and --process_id >= 0 (got 0, -1)")
    mesh = par.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {}
    assert par.process_slice(12) == slice(0, 12)
    assert par.process_slice(12, mesh) == slice(0, 12)
    assert par.host_local_batch(lambda s, n: (s, n), 12) == (0, 12)
    jm = jpar.make_mesh(data=1, model=1)
    assert par.data_sharding(mesh, 3).axes == tuple(
        jpar.data_sharding(jm, 3).spec)
    assert par.replicated(mesh).axes == tuple(jpar.replicated(jm).spec)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(par.shard_batch(x, mesh), x)
    assert torch.equal(par.global_batch_from_local(x, mesh), x)
    tree = {"a": x, "b": {"c": torch.ones(2)}}
    for placed in (par.replicate(tree, mesh), par.replicate_global(tree, mesh),
                   par.shard_params_global(tree, mesh, 1)):
        assert torch.equal(placed["a"], x)
    assert par.gather_replicated(tree, mesh) is tree
    assert par.first_local_value(torch.tensor(2.5)) == 2.5
    assert torch.equal(par.psum(x, mesh), x)
    assert torch.equal(par.all_gather(x, mesh), x)
    assert torch.equal(par.ppermute(x, [(0, 0)], mesh), x)
    assert par.is_main_process()


def test_model_shards_in_one_process():
    """ModelShards on a (1, 1) mesh: every leaf replicated, the module's
    parameters emptied between steps and whole inside ``whole``."""
    from ganreverser_tpu_torch.models import modules
    R = modules.init_parameters(zoo.create_R(DIMS, ND, "normal"),
                                torch.Generator().manual_seed(1))
    ref = [p.detach().clone() for p in R.parameters()]
    shards = par.ModelShards(R, par.make_mesh(), 1 << 10)
    assert all(p.numel() == 0 for p in R.parameters())
    with shards.whole() as m:
        for p, q in zip(m.parameters(), ref):
            assert torch.equal(p, q)
    assert all(p.numel() == 0 for p in R.parameters())
    assert [tuple(t.shape) for t in shards.local] == shards.shapes
