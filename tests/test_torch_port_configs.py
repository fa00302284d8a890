"""The port at two of BASELINE.json's configurations against the JAX
package on the CPU: config 1 (grayscale 1x32x32, noise 32, G+R inversion
at batch 64) and config 5 (rgb 3x128x128, noise 256, with latent
refinement). The fast forwards' plain versions (what the kernels are held
to on the card) against JAX's modules in evaluation, f32, within 1e-4 of
max(1, max |JAX|); the kernels' launch plans at these configurations'
shapes; and Q3's plain sums at config 5's widest K (R l27: 32 x 32 x 128
flattened) with every operand at +-127. Weights, latents and images are
numpy arrays from a seed, handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import models as M
from ganreverser_tpu.analysis import similarity as j_similarity
from ganreverser_tpu_torch.analysis import similarity
from ganreverser_tpu_torch.models import bridge, fastpath, modules
from ganreverser_tpu_torch.ops import approx_topk_kernel as S
from ganreverser_tpu_torch.ops import conv_operands as CO
from ganreverser_tpu_torch.ops import kmeans_kernel, quant as Q, topk_kernel

from torch_port_fixtures import one_thread  # noqa: F401

T = torch.from_numpy
CONFIG1 = ((1, 32, 32), 32)     # BASELINE.json configs[0]
CONFIG5 = ((3, 128, 128), 256)  # BASELINE.json configs[4]


def _close(out, ref, tol=1e-4):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _variables(model, in_shape, seed, amplify=1.0):
    """A JAX-layout variable tree of numpy arrays drawn from ``seed`` at
    the shapes ``model.init`` gives (traced, not run): kernels normal with
    std amplify / sqrt(fan-in), biases 0.1 normal, BatchNorm scales in
    [0.5, 1.5], running means 0.1 normal, variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda k: model.init(k, in_shape)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape, np.float32)
                    * np.float32(amplify / np.sqrt(fan_in)))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape, np.float32))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _shift_layers(tree):
    """Plain-R variables relabelled as the fixer's (l<i> -> l<i+1>)."""
    return {part: {f"l{int(k[1:]) + 1}": v for k, v in tree[part].items()}
            for part in ("params", "state")}


def _forwards(dims, nd, n, seed, fixer=True):
    """The port's fast G (kernel U and U's fused head), fast R and fast
    fixer-R on ``n`` rows (the fixer on the mask of generator seed 5)
    against JAX's G and R in evaluation (the fixer: R on x * m / 0.5). G's
    weights are dropped before R's are drawn."""
    c, h, w = dims
    f32 = torch.float32
    rng = np.random.default_rng(seed + 2)
    z = rng.standard_normal((n, nd), np.float32)
    x = rng.uniform(size=(n, h, w, c)).astype(np.float32)
    jg = M.create_G(dims, nd)
    gv = _variables(jg, (nd,), seed)
    ref = np.asarray(jg.apply(gv, jnp.asarray(z), train=False)[0])
    tg = bridge.to_torch(gv, "cpu")
    images = fastpath.make_fast_generator(dims, nd, f32)(tg, T(z))
    assert images.shape == (n, h, w, c)
    _close(images, ref)
    del gv, tg, images
    jr = M.create_R(dims, nd, "normal")
    rv = _variables(jr, (h, w, c), seed + 1)
    latents = fastpath.make_fast_inverter(dims, nd, "normal", f32)(
        bridge.to_torch(rv, "cpu"), T(x))
    _close(latents, jr.apply(rv, jnp.asarray(x), train=False)[0])
    if fixer:
        keep = modules.dropout_keep_mask(
            x.shape, 0.5, torch.Generator().manual_seed(5), "cpu").numpy()
        ref = jr.apply(rv, jnp.asarray(np.where(keep, x / 0.5, 0.0)),
                       train=False)[0]
        out = fastpath.make_fast_fixer(dims, nd, "normal", f32)(
            bridge.to_torch(_shift_layers(rv), "cpu"), T(x),
            torch.Generator().manual_seed(5))
        _close(out, ref)


def test_config1_forwards_match_jax():
    """Config 1 (1x32x32, noise 32) on 8 rows: G's 8x8x512 start, U at an
    8x8 input (a tile taller than the image on the card), R's 1-channel
    stem and its 8,192-wide flatten; the fixer-R on a given mask."""
    _forwards(*CONFIG1, 8, 10)


def test_config1_stage2_topk_matches_jax():
    """Stage ② at config 1 on 100 rows (G then R, f32), then stage ④'s
    cosine top-10 of three needles over the recovered latents: the latents
    within 1e-4 of JAX's G then R, the top-k values within 1e-5 of JAX's
    cosine_topk, the index sets equal on every row whose 10th score leads
    the 11th by more than that."""
    dims, nd = CONFIG1
    n, k = 100, 10
    jg, jr = M.create_G(dims, nd), M.create_R(dims, nd, "normal")
    gv = _variables(jg, (nd,), 20, amplify=2.0)
    rv = _variables(jr, (32, 32, 1), 21, amplify=2.0)
    z = np.random.default_rng(22).standard_normal((n, nd), np.float32)
    j_images = jg.apply(gv, jnp.asarray(z), train=False)[0]
    j_latents = jr.apply(rv, j_images, train=False)[0]
    f32 = torch.float32
    images = fastpath.make_fast_generator(dims, nd, f32)(
        bridge.to_torch(gv, "cpu"), T(z))
    latents = fastpath.make_fast_inverter(dims, nd, "normal", f32)(
        bridge.to_torch(rv, "cpu"), images)
    _close(latents, j_latents)
    needles = [0, 42, 99]
    jv, ji = j_similarity.cosine_topk(j_latents, jnp.asarray(needles), k)
    v, i = similarity.cosine_topk(latents, torch.tensor(needles), k)
    _close(v, jv, 1e-5)
    scores = np.asarray(j_similarity.cosine_scores(j_latents,
                                                   jnp.asarray(needles)))
    top = -np.sort(-scores, axis=1)
    separated = top[:, k - 1] - top[:, k] > 1e-5
    assert separated.any()
    for row in np.nonzero(separated)[0]:
        assert set(i[row].tolist()) == set(np.asarray(ji[row]).tolist())


def test_config5_forwards_match_jax():
    """Config 5 (3x128x128, noise 256) on 2 rows: G's 256 x 524,288 dense
    and its 32x32x512 reshape, U at 32x32 and 64x64 inputs, the head at
    128x128, R's 131,072-wide flatten into its 512-wide dense."""
    _forwards(*CONFIG5, 2, 50, fixer=False)


# (label, H, W, Ci, Co) of the tensor-core layers at each configuration (U
# at its input's resolution)
CONFIG_LAYERS = {
    "config 1": [("R block 1 l0", 32, 32, 1, 64),
                 ("R block 1 l1-2", 32, 32, 64, 64),
                 ("R block 2 l0", 16, 16, 64, 128),
                 ("R block 2 l1-2", 16, 16, 128, 128),
                 ("G stage 1", 8, 8, 512, 256),
                 ("G stage 2", 16, 16, 256, 128),
                 ("G head (Q1)", 32, 32, 128, 1)],
    "config 5": [("R block 1 l0", 128, 128, 3, 64),
                 ("R block 1 l1-2", 128, 128, 64, 64),
                 ("R block 2 l0", 64, 64, 64, 128),
                 ("R block 2 l1-2", 64, 64, 128, 128),
                 ("G stage 1", 32, 32, 512, 256),
                 ("G stage 2", 64, 64, 256, 128),
                 ("G head (Q1)", 128, 128, 128, 3)],
}
PLAN_CASES = [(cfg, *layer) for cfg, layers in CONFIG_LAYERS.items()
              for layer in layers]


@pytest.mark.parametrize("cfg,label,h,w,ci,co", PLAN_CASES,
                         ids=[f"{c}-{p[0]}" for c, *p in PLAN_CASES])
def test_tile_plans_of_the_configs(cfg, label, h, w, ci, co):
    """The bf16 plan (B, U) and the int8 plan (Q1, Q2: f32 output, int8
    elements) of each layer fit the block's shared memory with the tile's
    invariants; U at config 1's 8x8 input takes a 16 x 8 tile, taller than
    the image, and the 1-channel stem is padded to 16 (bf16) or 32 (int8)
    channels."""
    for plan, eb in ((CO.tile_plan(h, w, ci, co), 2),
                     (CO.tile_plan(h, w, ci, co, out_bytes=4, elem_bytes=1),
                      1)):
        assert plan.bh * plan.bw == CO.BM
        assert plan.bh % 2 == 0 and plan.bw % 2 == 0
        assert plan.bn in CO.WIDTHS_N and plan.bn >= min(co, 256)
        cp = CO.padded_channels(ci, eb)
        assert plan.bk == (cp if cp <= 64 // eb else 128 // eb)
        stage = -(-(CO.BM + plan.bn) * plan.bk * eb // CO.ALIGN) * CO.ALIGN
        assert 2 <= plan.stages <= CO.MAX_STAGES
        assert plan.smem_bytes == CO.ALIGN + plan.stages * (stage + 16)
        assert plan.smem_bytes <= CO.MAX_SHARED_BYTES
        assert CO.staged_bytes(plan.bn, 4 if eb == 1 else 2) <= (
            plan.stages * stage)
    if w <= 8:
        assert (plan.bh, plan.bw) == (16, 8) and plan.bh > h
    if ci == 1:
        assert (CO.padded_channels(1), CO.padded_channels(1, 1)) == (16, 32)


@pytest.mark.parametrize("dims,n,ws_shape", [
    (CONFIG1[0], 256, (1, 4, 256, 16, 16, 9)),
    (CONFIG5[0], 256, (1, 4, 256, 64, 64, 27))])
def test_head_plans_of_the_configs(dims, n, ws_shape):
    """U's fused head at G's stage 2 with C = 1 on 32x32 output and C = 3
    on 128x128: the plan within the block's bytes, the staged partials in
    the ring; config 5's tap partials are 453 MB of f32 per 256-row
    chunk."""
    c, h, w = dims
    p = CO.head_plan(h // 2, w // 2, 256, 128, c)
    assert p.bn <= CO.HEAD_MAX_BN
    assert p.smem_bytes <= CO.MAX_SHARED_BYTES
    stage = -(-(CO.BM * p.bk * 2 + p.bn * p.bk * 2) // CO.ALIGN) * CO.ALIGN
    assert CO.BM * 9 * c * 4 <= p.stages * stage
    shape = CO.head_workspace_shape(n, h // 2, w // 2, 128, c, p.bn)
    assert shape == ws_shape
    if c == 3:
        assert 4 * int(np.prod(shape)) == 452_984_832


@pytest.mark.parametrize("n,d,q,slices", [
    (10_000, 32, 10, None), (10_000, 1024, 10, None),     # config 1 apply_r
    (10_240, 32, 256, None), (10_240, 1024, 256, None),   # config 1 e2e
    (2_560, 256, 10, None), (2_560, 49_152, 10, 19),      # config 5 apply_r
    (10_240, 256, 256, None), (10_240, 49_152, 256, 12)])  # config 5 e2e
def test_cosine_plans_of_the_configs(n, d, q, slices):
    """Kernel C at the configs' searches: D = 49,152 (config 5's pixels)
    is 768 chunks, so at least 12 slices of at most MAX_SLICE_CHUNKS; the
    slices cover D in order; the ring fits; the workspace counts floats
    below 2^31."""
    p = topk_kernel.cosine_plan(n, d, q)
    chunks = -(-p.dp // 64)
    assert -(-chunks // p.slices) <= topk_kernel.MAX_SLICE_CHUNKS
    bounds = topk_kernel.slice_bounds(p.dp, p.slices)
    assert bounds[0][0] == 0 and bounds[-1][1] == p.dp
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(bounds, bounds[1:]))
    assert all(b - a <= 64 * topk_kernel.MAX_SLICE_CHUNKS for a, b in bounds)
    per_sm = 3 if p.bnq <= 64 else 1
    assert per_sm * (p.smem_bytes + 1024) <= 233_472
    assert topk_kernel.workspace_floats(p, q, n) < 2 ** 31
    if slices is not None:
        assert p.slices == slices


@pytest.mark.parametrize("n,k,m,splits", [
    (256, 32, 32_768, None), (256, 8_192, 512, None), (256, 512, 32, None),
    (256, 256, 524_288, None), (256, 131_072, 512, None),
    (256, 512, 256, None)])
def test_dense_plans_of_the_configs(n, k, m, splits):
    """Q3 at G l0, R l27 and R l31 of both configs: the splits divide K's
    chunks and cover K' once, each split at least DENSE_MIN_CHUNKS deep,
    the ring holds the staged f32 tile within the block's bytes."""
    plan, splits = Q.dense_plan(n, k, m)
    kp = CO.padded_channels(k, 1)
    chunks = -(-kp // plan.bk)
    assert chunks % splits == 0
    assert chunks // splits >= min(chunks, Q.DENSE_MIN_CHUNKS)
    stage = -(-(CO.BM + plan.bn) * plan.bk // CO.ALIGN) * CO.ALIGN
    assert CO.staged_bytes(plan.bn, 4) <= plan.stages * stage
    assert plan.smem_bytes <= CO.MAX_SHARED_BYTES
    covered = np.zeros(kp, np.int64)
    for k0, k1 in Q.dense_k_ranges(k, plan, splits):
        covered[k0:k1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("n,d,k", [(10_000, 32, 20), (2_560, 256, 20)])
def test_kmeans_plans_of_the_configs(n, d, k):
    """Kernel K at the configs' latents (D = 32 and 256, apply_r's K =
    20): the assignment's tiles fit, and the Lloyd grid covers every tile
    at a resident wave of two blocks an SM."""
    plan = kmeans_kernel.kmeans_plan(d, k)
    assert plan.smem_bytes <= kmeans_kernel.MAX_SHARED_BYTES
    lloyd = kmeans_kernel.lloyd_plan(n, d, k, 264)
    tiles = -(-n // lloyd.rows)
    assert lloyd.grid <= 264
    assert (lloyd.grid - 1) * lloyd.tiles_per_block < tiles <= (
        lloyd.grid * lloyd.tiles_per_block)


@pytest.mark.parametrize("q,n,k", [(10, 10_000, 100), (256, 10_240, 100),
                                   (10, 2_560, 100)])
@pytest.mark.parametrize("r", [0.95, 1.0])
def test_select_plans_of_the_configs(q, n, k, r):
    """Kernel S at the configs' searches (apply_r's 10 needles over N =
    10,000 and 2,560, the e2e chunks of 256 over 10,240): one launch's plan
    within the block's bytes, the bins the rule's."""
    plan = S.select_plan(q, n, k, r)
    assert plan.bins == S.approx_plan(n, k, r)
    assert plan.smem + S.SMEM_FIXED <= S.SMEM_LIMIT


def test_q3_plain_at_config5_widest_k_is_exact():
    """Q3's plain sums at R l27 of config 5 (K = 131,072, M = 512) with
    every operand at +-127: 127^2 * 131,072 = 2,114,060,288 lies 1.6 %
    under 2^31 - 1, and the sums, whole and split as the kernel takes them,
    equal the int64 sums exactly; the dequantised output is their f64
    product rounded once."""
    k, m = 131_072, 512
    rng = np.random.default_rng(7)
    xq = np.where(rng.uniform(size=(4, k)) < 0.5, -127, 127).astype(np.int8)
    xq[0], xq[1] = 127, -127
    wq = np.where(rng.uniform(size=(k, m)) < 0.5, -127, 127).astype(np.int8)
    wq[:, 0] = 127
    want = xq.astype(np.int64) @ wq.astype(np.int64)
    assert want[0, 0] == 127 * 127 * k == 2_114_060_288
    assert want[1, 0] == -2_114_060_288
    got = Q.dense_int32_plain(T(xq), T(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    plan, splits = Q.dense_plan(256, k, m)
    assert splits > 1
    split = Q.dense_sums_plain(T(xq), Q.dense_operand(T(wq)), plan, splits)
    np.testing.assert_array_equal(split.numpy(), want)
    xs = torch.tensor(0.01)
    ws = torch.full((m,), 0.002)
    b = torch.zeros(m)
    y = Q.quant_dense_plain(T(xq), xs, T(wq), ws, b)
    deq = np.float64(np.float32(0.01) * np.float32(0.002))
    np.testing.assert_array_equal(
        y.numpy(), (want.astype(np.float32).astype(np.float64) * deq
                    ).astype(np.float32))
