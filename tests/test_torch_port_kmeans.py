"""Kernel K's plain version and the port's kmeans against the JAX package:
the Lloyd step against ``kmeans_step_pallas`` in interpret mode (as
tests/test_pallas.py runs it), whole runs against ``kmeans_pallas`` and the
lax ``kmeans`` with the initial rows ``jax.random.choice`` drew, and the
min-cosine membership. f32; counts exact, centroids and sums to 1e-5 (f32
sums in another order). Whole runs are compared on well-separated blobs
only: on random data a near-tie flips an argmin and the trajectories part.
On CPU tensors the wrapper takes the plain version and launches nothing."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import analysis as A
from ganreverser_tpu.ops.kmeans_kernel import (_kmeans_sums_counts,
                                               kmeans_pallas,
                                               kmeans_step_pallas)
from ganreverser_tpu_torch.ops import kmeans_kernel

from torch_port_fixtures import one_thread  # noqa: F401

# the module (the package exports its function ``kmeans`` under the name)
K = importlib.import_module("ganreverser_tpu_torch.analysis.kmeans")

T = torch.from_numpy


def _blobs(rng, n, d, k, spread=0.1, dist=5.0):
    centres = rng.normal(size=(k, d)) * dist
    labels = np.arange(n) % k
    x = centres[labels] + rng.normal(size=(n, d)) * spread
    return x.astype(np.float32)


@pytest.mark.parametrize("n,d,k", [(1024, 32, 8), (512, 100, 20)])
def test_kmeans_step_matches_pallas(rng, n, d, k):
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    ref_c, ref_counts = kmeans_step_pallas(jnp.asarray(x), jnp.asarray(c),
                                           tile_n=256, interpret=True)
    before = kmeans_kernel.kmeans_step.launches
    new_c, counts, sums, assign = kmeans_kernel.kmeans_step(
        T(x), T(c), details=True)
    assert kmeans_kernel.kmeans_step.launches == before
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_allclose(new_c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)
    # the details: the assignment and sums behind the same step
    assert assign.shape == (n,) and counts.sum().item() == n
    np.testing.assert_array_equal(
        np.bincount(assign.numpy(), minlength=k), counts.numpy())
    np.testing.assert_allclose(
        sums.numpy(), np.stack([x[assign.numpy() == j].sum(0)
                                for j in range(k)]), rtol=1e-5, atol=1e-4)
    step_c, step_counts = kmeans_kernel.kmeans_step(T(x), T(c))
    np.testing.assert_array_equal(step_c.numpy(), new_c.numpy())
    np.testing.assert_array_equal(step_counts.numpy(), counts.numpy())


def test_kmeans_step_empty_cluster_matches_pallas(rng):
    """A centroid far from every point keeps its place, in both packages."""
    x = rng.normal(size=(256, 16)).astype(np.float32)
    c = np.concatenate([np.zeros((1, 16)), np.full((1, 16), 1e6)]
                       ).astype(np.float32)
    ref_c, ref_counts = kmeans_step_pallas(jnp.asarray(x), jnp.asarray(c),
                                           tile_n=256, interpret=True)
    new_c, counts = kmeans_kernel.kmeans_step(T(x), T(c))
    assert counts[1].item() == 0.0 == float(ref_counts[1])
    np.testing.assert_array_equal(new_c[1].numpy(), c[1])
    np.testing.assert_allclose(new_c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_step_takes_first_index_on_ties():
    x = torch.tensor([[0.0, 0.0], [2.0, 0.0]])
    c = torch.tensor([[1.0, 0.0], [1.0, 0.0], [-5.0, 0.0]])
    _, counts, _, assign = kmeans_kernel.kmeans_step(x, c, details=True)
    assert assign.tolist() == [0, 0]
    assert counts.tolist() == [2.0, 0.0, 0.0]


@pytest.mark.parametrize("n", [300, 517])
def test_kmeans_run_matches_jax_on_blobs(rng, n):
    """Ragged N (the TPU path pads to its tile and masks; the port takes N
    as it is) with the init rows drawn by jax.random.choice."""
    k, iters, d = 4, 6, 10
    x = _blobs(rng, n, d, k)
    key = jax.random.PRNGKey(7)
    init_idx = np.asarray(jax.random.choice(key, n, (k,), replace=False))
    ref_c, ref_counts = kmeans_pallas(key, jnp.asarray(x), k, iters,
                                      tile_n=128, interpret=True)
    lax_c, lax_counts = A.kmeans(key, jnp.asarray(x), k, iters)
    c, counts = K.kmeans(T(x), k, iters, init_idx=T(np.array(init_idx)))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(lax_counts))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(lax_c), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("iters", [1, 3, 15])
def test_kmeans_lloyd_plain_matches_pallas(rng, iters):
    """The plain whole run against kmeans_pallas from the rows
    jax.random.choice drew: the same last assignment (counts) and the
    centroids to the step test's 1e-5; the wrapper on CPU tensors is the
    plain version and launches nothing."""
    n, k, d = 300, 5, 12
    x = _blobs(rng, n, d, k, spread=0.5, dist=2.0)
    key = jax.random.PRNGKey(iters)
    init_idx = np.asarray(jax.random.choice(key, n, (k,), replace=False))
    ref_c, ref_counts = kmeans_pallas(key, jnp.asarray(x), k, iters,
                                      interpret=True)
    before = kmeans_kernel.kmeans_lloyd.launches
    c, counts = kmeans_kernel.kmeans_lloyd(T(x), T(x[init_idx]), iters)
    assert kmeans_kernel.kmeans_lloyd.launches == before
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)
    plain = kmeans_kernel.kmeans_lloyd_plain(T(x), T(x[init_idx]), iters)
    np.testing.assert_array_equal(plain[0].numpy(), c.numpy())


@pytest.mark.parametrize("n,d,k", [(1024, 32, 5), (512, 100, 20),
                                   (200, 7, 3)])
def test_segment_sums_match_pallas_sums(rng, n, d, k):
    """The kernel's summation order (sorted rows in segments of 64, then
    the segments) in plain PyTorch against the JAX step's raw sums on the
    same assignment: counts exact, sums to 1e-5 relative (f32 sums in
    another order). Clusters of 200 rows span four segments; the last
    centroid is far from every row, so its cluster is empty."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    c[-1] = 1e4
    ref_sums, ref_counts = _kmeans_sums_counts(jnp.asarray(x), jnp.asarray(c),
                                               n, True)
    _, _, _, assign = kmeans_kernel.kmeans_step_plain(T(x), T(c),
                                                      details=True)
    sums, counts = kmeans_kernel.kmeans_segment_sums_plain(T(x), assign, k)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    assert counts[-1].item() == 0.0 and not sums[-1].any()
    np.testing.assert_allclose(sums.numpy(), np.asarray(ref_sums), rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref_sums).max()))
    # the order itself: cluster 0's sum is its sorted rows' segments
    rows = np.nonzero(assign.numpy() == 0)[0]
    segs = []
    for s0 in range(0, len(rows), 64):
        acc = np.zeros(d, np.float32)
        for r in rows[s0:s0 + 64]:
            acc = acc + x[r]
        segs.append(acc)
    total = np.zeros(d, np.float32)
    for acc in segs:
        total = total + acc
    np.testing.assert_array_equal(sums[0].numpy(), total)


def test_kmeans_init_from_generator(rng):
    x = T(_blobs(rng, 200, 5, 3))
    runs = [K.kmeans(x, 3, 0, generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0][0].numpy(), runs[1][0].numpy())
    assert not np.array_equal(runs[0][0].numpy(), runs[2][0].numpy())
    # distinct data rows, and zero counts before any step
    rows = {tuple(r) for r in runs[0][0].numpy()}
    assert len(rows) == 3 and rows <= {tuple(r) for r in x.numpy()}
    assert runs[0][1].tolist() == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError):
        K.kmeans(x, 3, 1)
    with pytest.raises(ValueError):
        K.kmeans(x, 201, 1, generator=torch.Generator())


def test_assign_min_cosine_and_members_match_jax(rng):
    x = _blobs(rng, 240, 12, 5, spread=0.5)
    c = _blobs(rng, 5, 12, 5, spread=0.0)
    ref_assign, ref_sims = A.assign_min_cosine(jnp.asarray(x), jnp.asarray(c))
    assign, sims = K.assign_min_cosine(T(x), T(c))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ref_assign))
    np.testing.assert_allclose(sims.numpy(), np.asarray(ref_sims), rtol=1e-6,
                               atol=1e-6)
    for ci in range(5):
        for cap in (3, 71):
            np.testing.assert_array_equal(
                K.cluster_members(assign.numpy(), np.asarray(ref_sims), ci,
                                  cap),
                A.cluster_members(np.asarray(ref_assign),
                                  np.asarray(ref_sims), ci, cap))
    # the quirk: the most dissimilar centroid wins
    a, s = K.assign_min_cosine(torch.tensor([[1.0, 0.0]]),
                               torch.tensor([[1.0, 0.0], [-1.0, 0.01]]))
    assert a.item() == 1 and s.item() < 0


def test_cluster_members_stable_descending():
    assign = np.array([0, 0, 1, 0, 0])
    score = np.array([0.1, 0.9, 0.5, 0.4, 0.9])
    assert K.cluster_members(assign, score, 0, 3).tolist() == [1, 4, 3]
    assert K.cluster_members(assign, score, 2, 3).tolist() == []


def test_assign_euclidean_matches_jax(rng):
    x = _blobs(rng, 100, 6, 3)
    c = _blobs(rng, 3, 6, 3, spread=0.0)
    ref_assign, ref_dist = A.assign_euclidean(jnp.asarray(x), jnp.asarray(c))
    assign, dist = K.assign_euclidean(T(x), T(c))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ref_assign))
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref_dist), rtol=1e-4,
                               atol=1e-4)


def test_kmeans_step_refuses_bad_arguments():
    with pytest.raises(ValueError):  # D differs
        kmeans_kernel.kmeans_step(torch.zeros(4, 3), torch.zeros(2, 4))
    with pytest.raises(ValueError):  # not (N, D)
        kmeans_kernel.kmeans_step(torch.zeros(4), torch.zeros(2, 4))
    with pytest.raises(ValueError):  # no clusters
        kmeans_kernel.kmeans_step(torch.zeros(4, 3), torch.zeros(0, 3))
    with pytest.raises(ValueError):  # another device type
        kmeans_kernel.kmeans_step(torch.zeros(4, 3, device="meta"),
                                  torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError):  # mixed devices
        kmeans_kernel.kmeans_step(torch.zeros(4, 3),
                                  torch.zeros(2, 3, device="meta"))


@pytest.mark.parametrize("k,d,rows,kt", [(20, 100, 64, 20),
                                         (256, 100, 64, 64),
                                         (64, 512, 32, 64),
                                         (1000, 4096, 4, 8)])
def test_kmeans_plan_of_main_path_shapes(k, d, rows, kt):
    """The assignment launch's tiles: every (K, D) the JAX package takes at
    D <= 4,096 gets a plan within the block's 227 KB (apply_r's default K
    = 20 and --clusters 256 at noise 100, K = 64 at noise 512, and a wide
    case), with no refusal; its bytes are the rows and the centroid tile at
    stride D + 1, the tile's norms and the dot products."""
    plan = kmeans_kernel.kmeans_plan(d, k)
    assert (plan.rows, plan.kt) == (rows, kt)
    assert plan.smem_bytes == 4 * ((rows + kt) * (d + 1) + kt + rows * kt)
    assert plan.smem_bytes <= kmeans_kernel.MAX_SHARED_BYTES
    # the wider tiles of each halving step would not have fitted
    if (rows, kt) != (64, min(k, 64)):
        wider = (2 * rows, kt) if rows < kt else (rows, 2 * kt)
        assert 4 * ((wider[0] + wider[1]) * (d + 1) + wider[1]
                    + wider[0] * wider[1]) > kmeans_kernel.MAX_SHARED_BYTES


@pytest.mark.parametrize("n,d,k,resident,rows,grid,per_block", [
    (10_000, 100, 20, 264, 40, 250, 1),    # apply_r: 40 rows a block
    (10_000, 100, 256, 264, 40, 250, 1),   # --clusters 256
    (10_000, 100, 20, 132, 64, 79, 2),     # 157 tiles of 64 on 132 blocks
    (777, 100, 20, 264, 4, 195, 1),
    (10_000, 4096, 1000, 132, 4, 132, 19),  # 2,500 tiles of 4 rows
    (1_000, 20_000, 5, 132, 1, 125, 8),     # tiles of 1 row: kept
])
def test_lloyd_plan_grid_and_workspace(n, d, k, resident, rows, grid,
                                       per_block):
    """The Lloyd launch's grid covers every tile of rows with at most the
    resident blocks and no idle block, with tiles of fewer rows (in fours)
    than the assignment's plan where that fills more blocks; its workspace
    holds 2 K D centroids, their K norms and min(N, ceil(N / 64) + K)
    segment sums of D floats, and the permutation, the (K, grid) table, the K counts, two
    (K + 1) starts and the segments' clusters in ints."""
    plan = kmeans_kernel.lloyd_plan(n, d, k, resident)
    max_rows, kt, smem = kmeans_kernel.kmeans_plan(d, k)
    assert (plan.rows, plan.kt) == (rows, kt) and rows <= max_rows
    assert plan.smem_bytes == max(smem, 4 * 256)
    assert (plan.grid, plan.tiles_per_block) == (grid, per_block)
    tiles = -(-n // rows)
    assert plan.grid <= resident
    assert (plan.grid - 1) * per_block < tiles <= plan.grid * per_block
    segs = min(n, -(-n // 64) + k)
    assert plan.max_segments == segs
    assert plan.ws_floats == 2 * k * d + k + segs * d
    assert plan.ws_ints == n + k * grid + k + 2 * (k + 1) + segs
    with pytest.raises(RuntimeError):
        kmeans_kernel.lloyd_plan(n, d, k, 0)
