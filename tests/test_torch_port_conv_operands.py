"""The operands and tile plan of the bf16 tensor-core convolutions
(ops/conv_operands.py) against the JAX package: the padded, K-major
weights of the 9-tap conv and of U's 16 phase taps, summed tap by tap and
BK channels at a time as the kernel sums them (``implicit_gemm_plain``),
then the epilogue, against the JAX ``conv_block`` and U in interpret mode,
as the JAX tests run them on the CPU. f32 within 1e-5 of the output's
scale (f32 sums in another order); bf16 within 3e-2 of it (one rounding of
the output, which may land on a neighbouring bf16 value). Kernel B7: the
same conv operands with the statistics in the kernel's order (per tile,
ragged pixels masked, then the fixed-order finish) against a lax conv and
its per-channel sums (y within 1e-5 of its scale, the sums within 1e-4 of
their magnitudes: f32 sums of exact bf16 products in another order).
Kernel B8: the stacked K-major weights summed stage by stage against the
JAX U. And the plan of every layer of R, G3 and D2 at 3x64x64, of the
probes' shapes and of the card tests' ragged shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu.ops.conv_block_kernel import conv_block as j_conv_block
from ganreverser_tpu.ops.upsample_conv_kernel import (
    upsample2_conv3x3_bn_act as j_upsample)
from ganreverser_tpu_torch.ops import conv_operands as co_
from ganreverser_tpu_torch.ops import conv_stats_kernel as cs
from ganreverser_tpu_torch.ops.upsample_conv_kernel import phase_kernels
from ganreverser_tpu_torch.ops.upsample_v2_kernel import stacked_phase_kernels

from torch_port_fixtures import one_thread  # noqa: F401

T = torch.from_numpy
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
CHANNELS = [(3, 5), (20, 70), (70, 72)]   # (Ci, Co): a stem, two ragged


def _close(out: torch.Tensor, ref: np.ndarray, dtype: str) -> None:
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= TOL[dtype] * max(1.0, np.abs(ref).max()), err


def _operands(rng, shape, ci, co, dtype):
    """x, the (3,3,Ci,Co) kernel, scale, shift; x and the kernel rounded to
    ``dtype`` once, as both packages receive them."""
    x = rng.normal(size=shape + (ci,)).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, co).astype(np.float32)
    sh = (rng.normal(size=co) * 0.1).astype(np.float32)
    jdt = getattr(jnp, dtype)
    xj, kj = jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt)
    tdt = getattr(torch, dtype)
    xt, kt = (T(np.array(a.astype(jnp.float32))).to(tdt) for a in (xj, kj))
    return (xj, kj, xt, kt, sc, sh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("ci,co", CHANNELS)
def test_conv3x3_operands_match_jax_conv_block(rng, ci, co, pool, dtype):
    """One conv + BN + ELU layer (+ pool): the padded input and (9, Co,
    Ci8) weights in the kernel's K order against the JAX conv_block, on a
    ragged image (H, W off the 8 x 16 and 16 x 8 tiles)."""
    shape = (2, 10, 14) if pool else (2, 9, 7)
    xj, kj, xt, kt, sc, sh = _operands(rng, shape, ci, co, dtype)
    ref = j_conv_block(xj, (kj,), (sc,), (sh,), act="elu", pool=pool,
                       tile_n=1).astype(jnp.float32)
    plan = co_.tile_plan(shape[1], shape[2], ci, co)
    x8 = co_.pad_channels(xt)
    wk = co_.conv3x3_weights(kt, xt.dtype)
    assert x8.shape[-1] == wk.shape[-1] == co_.padded_channels(ci)
    assert wk.shape == (9, co, x8.shape[-1]) and wk.dtype == xt.dtype
    acc = co_.implicit_gemm_plain(x8, wk, co_.CONV3X3_TAPS, plan.bk)
    y = acc * T(sc) + T(sh)
    y = torch.where(y > 0, y, torch.exp(torch.clamp_max(y, 0.0)) - 1.0)
    y = y.to(xt.dtype)
    if pool:
        n, h, w, c = y.shape
        y = y.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    assert tuple(y.shape) == ref.shape
    _close(y, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci,co", CHANNELS)
def test_phase_operands_match_jax_upsample(rng, ci, co, dtype):
    """Kernel U: the 16 phase taps laid out (16, Co, Ci8), each output phase
    (a, b) summed over its four taps in the kernel's K order, interleaved
    into the (N, 2H, 2W, Co) output, against the JAX kernel."""
    xj, kj, xt, kt, sc, sh = _operands(rng, (2, 5, 3), ci, co, dtype)
    ref = j_upsample(xj, kj, sc, sh, act="relu",
                     tile_n=1).astype(jnp.float32)
    n, h, w, _ = xt.shape
    plan = co_.tile_plan(h, w, ci, co)
    x8 = co_.pad_channels(xt)
    wk = co_.kmajor(phase_kernels(kt).reshape(16, ci, co), xt.dtype)
    assert wk.shape == (16, co, x8.shape[-1])
    acc = torch.empty((n, h, 2, w, 2, co))
    for a in (0, 1):
        for b in (0, 1):
            acc[:, :, a, :, b] = co_.implicit_gemm_plain(
                x8, wk, co_.phase_taps(a, b), plan.bk)
    y = torch.clamp_min(acc.reshape(n, 2 * h, 2 * w, co) * T(sc) + T(sh), 0.0)
    assert tuple(y.shape) == ref.shape
    _close(y.to(xt.dtype), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 9, 7), (2, 10, 14)])
@pytest.mark.parametrize("ci,co", CHANNELS)
def test_conv_stats_operands_match_lax(rng, ci, co, shape, dtype):
    """Kernel B7: kernel B's padded input and (9, Co, Ci') weights in the
    kernel's K order, then the per-tile partial sums of y and y^2 in the
    kernel's order over the plan's tiles (ragged pixels masked) and the
    fixed-order finish, against a lax conv (f32 sums) and its per-channel
    sums, on ragged images."""
    xj, kj, xt, kt, _, _ = _operands(rng, shape, ci, co, dtype)
    ref = jax.lax.conv_general_dilated(
        xj, kj, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    plan = co_.tile_plan(shape[1], shape[2], ci, co, out_bytes=4)
    y = co_.implicit_gemm_plain(co_.pad_channels(xt),
                                co_.conv3x3_weights(kt, xt.dtype),
                                co_.CONV3X3_TAPS, plan.bk)
    part_s, part_q = cs.tile_partials_plain(y, plan.bh, plan.bw)
    tiles = shape[0] * -(-shape[1] // plan.bh) * -(-shape[2] // plan.bw)
    assert part_s.shape == part_q.shape == (co, tiles)
    s, q = cs.finish_plain(part_s, part_q)
    assert tuple(y.shape) == ref.shape and y.dtype == torch.float32
    _close(y, ref, "float32")
    ref = np.asarray(ref)
    mag = np.maximum(np.abs(ref).sum(axis=(0, 1, 2)), 1.0)
    ref_q = (ref * ref).sum(axis=(0, 1, 2))
    assert (np.abs(s.numpy() - ref.sum(axis=(0, 1, 2))) / mag).max() <= 1e-4
    assert (np.abs(q.numpy() - ref_q) / np.maximum(ref_q, 1.0)).max() <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci,co", CHANNELS)
def test_stacked_operands_match_jax_upsample(rng, ci, co, dtype):
    """Kernel B8: the stacked phase weights laid out (4, Co, 4 Kp), each
    phase one K loop of 4 Kp summed stage by stage in the kernel's order,
    interleaved into the (N, 2H, 2W, Co) output, against the JAX kernel U
    (whose phase kernels are rounded from the rounded kernel; B8's are
    summed in f32 and rounded once)."""
    xj, kj, xt, _, sc, sh = _operands(rng, (2, 5, 3), ci, co, dtype)
    ref = j_upsample(xj, kj, sc, sh, act="relu",
                     tile_n=1).astype(jnp.float32)
    n, h, w, _ = xt.shape
    plan = co_.tile_plan(h, w, ci, co)
    x8 = co_.pad_channels(xt)
    k = T(np.array(kj.astype(jnp.float32)))
    ws = co_.stacked_kmajor(stacked_phase_kernels(k), xt.dtype, plan.bk)
    assert ws.shape == (4, co, 4 * co_.stacked_depth(ci, plan.bk))
    acc = torch.empty((n, h, 2, w, 2, co))
    for p in range(4):
        acc[:, :, p // 2, :, p % 2] = co_.stacked_gemm_plain(x8, ws, p,
                                                             plan.bk)
    y = torch.clamp_min(acc.reshape(n, 2 * h, 2 * w, co) * T(sc) + T(sh), 0.0)
    assert tuple(y.shape) == ref.shape
    _close(y.to(xt.dtype), ref, dtype)


def test_stacked_kmajor_layout():
    """Phase p's tap t is its (Ci, Co) block of the stacked weights,
    transposed, at K offset t * Kp; zero from Ci to the next Kp; Kp the
    padded Ci rounded up to BK."""
    assert [co_.stacked_depth(c, bk) for c, bk in (
        (3, 16), (20, 32), (70, 64), (256, 64), (512, 64))] == [
        16, 32, 128, 256, 512]
    ci, co = 5, 7
    k4 = torch.randn(4, 4 * ci, co)
    ws = co_.stacked_kmajor(k4, torch.bfloat16, 16)
    assert ws.shape == (4, co, 64) and ws.dtype == torch.bfloat16
    assert ws.is_contiguous()
    for p in range(4):
        for t in range(4):
            blk = ws[p, :, t * 16:(t + 1) * 16]
            assert torch.equal(blk[:, :ci],
                               k4[p, t * ci:(t + 1) * ci].T.to(torch.bfloat16))
            assert not blk[:, ci:].any()


def test_conv_stats_finish_order():
    """The plain statistics in the kernel's order add up to the plain sums:
    one tile and many (more than the finish kernel's 256 threads)."""
    y = torch.randn(5, 33, 70, 3)
    for bh, bw in ((8, 16), (16, 8)):
        s, q = cs.finish_plain(*cs.tile_partials_plain(y, bh, bw))
        assert torch.allclose(s, y.sum(dim=(0, 1, 2)), rtol=0, atol=1e-3)
        assert torch.allclose(q, (y * y).sum(dim=(0, 1, 2)), rtol=1e-5)
    part = torch.arange(600.0).reshape(1, 600)
    assert cs.finish_plain(part, part)[0].item() == 599 * 600 / 2


def test_padding_and_kmajor_layout():
    """Zero channels up to a multiple of 8, and up to 16 or 32 below that,
    the data untouched; tap t of the K-major weights is kernel[t // 3,
    t % 3] transposed; channels already padded are left as they are."""
    assert [co_.padded_channels(c) for c in (1, 3, 8, 9, 16, 17, 20, 32,
                                             33, 64, 70, 512)] == [
        16, 16, 16, 16, 16, 32, 32, 32, 40, 64, 72, 512]
    x = torch.randn(2, 3, 4, 5)
    x8 = co_.pad_channels(x)
    assert x8.shape == (2, 3, 4, 16)
    assert torch.equal(x8[..., :5], x) and not x8[..., 5:].any()
    assert torch.equal(co_.pad_channels(x8), x8)
    k = torch.randn(3, 3, 5, 7)
    wk = co_.conv3x3_weights(k, torch.bfloat16)
    assert wk.shape == (9, 7, 16) and wk.is_contiguous()
    for t in range(9):
        assert torch.equal(wk[t, :, :5], k[t // 3, t % 3].T.to(torch.bfloat16))
    assert not wk[..., 5:].any()
    assert co_.phase_taps(0, 0) == ((-1, -1, 0), (-1, 0, 1), (0, -1, 4),
                                    (0, 0, 5))
    assert co_.CONV3X3_TAPS[4] == (0, 0, 4)


# (label, H, W, Ci, Co) of every tensor-core layer at 3x64x64: R's two
# blocks, G3's two upsample stages (at the input's resolution), D2's five
# conv + PReLU layers; then the card tests' ragged shapes
PLAN_LAYERS = [
    ("R block 1 l0", 64, 64, 3, 64), ("R block 1 l1-2", 64, 64, 64, 64),
    ("R block 2 l0", 32, 32, 64, 128), ("R block 2 l1-2", 32, 32, 128, 128),
    ("G3 stage 1", 16, 16, 512, 256), ("G3 stage 2", 32, 32, 256, 128),
    ("D2 stem l0", 64, 64, 3, 128), ("D2 stem l1", 64, 64, 128, 128),
    ("D2 right l0", 32, 32, 128, 128), ("D2 right l2", 16, 16, 128, 256),
    ("D2 right l3", 16, 16, 256, 256),
    ("ragged stem", 10, 6, 3, 70), ("ragged Co 5", 10, 6, 70, 5),
    ("ragged U", 5, 7, 20, 72), ("ragged head U", 9, 4, 33, 130),
    ("wide Co", 6, 6, 64, 300),
    ("one pixel", 1, 1, 8, 8),
    ("B7 probe", 64, 64, 256, 128), ("B7 stem Co 300", 6, 6, 3, 300),
]


@pytest.mark.parametrize("label,h,w,ci,co", PLAN_LAYERS,
                         ids=[p[0] for p in PLAN_LAYERS])
def test_tile_plan(label, h, w, ci, co):
    plan = co_.tile_plan(h, w, ci, co)
    assert plan.bh * plan.bw == co_.BM == 128
    assert plan.bh % 2 == 0 and plan.bw % 2 == 0      # the fused pool's
    assert plan.bn % 8 == 0 and plan.bn <= 256 and plan.bn in co_.WIDTHS_N
    assert plan.bn >= min(co, 256)                    # one tile covers Co
    # a stem computes 16 or 32 deep, not 64
    cp = co_.padded_channels(ci)
    assert plan.bk == (cp if cp <= 32 else 64)
    stage = -(-(128 * plan.bk * 2 + plan.bn * plan.bk * 2) // 1024) * 1024
    assert 2 <= plan.stages <= co_.MAX_STAGES
    assert plan.smem_bytes == 1024 + plan.stages * (stage + 16)
    assert plan.smem_bytes <= co_.MAX_SHARED_BYTES
    # the epilogue's staged tile reuses the ring
    assert 128 * (plan.bn + 8) * 2 <= plan.stages * stage
    if plan.bn <= 64:  # three blocks fit one SM's 228 KB
        assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.stages * stage <= co_.RING_BYTES[plan.bn]
    if w >= 16:
        assert (plan.bh, plan.bw) == (8, 16)
    # B7's plan: the same tile, a ring that holds the f32 staged tile
    f32 = co_.tile_plan(h, w, ci, co, out_bytes=4)
    assert f32[:4] == plan[:4] and f32.stages >= plan.stages
    assert co_.staged_bytes(f32.bn, 4) == 128 * (f32.bn + 4) * 4
    assert co_.staged_bytes(f32.bn, 4) <= f32.stages * stage
    assert f32.smem_bytes == 1024 + f32.stages * (stage + 16)
    assert f32.smem_bytes <= co_.MAX_SHARED_BYTES
    if f32.stages > plan.stages:   # only where the bf16 ring is too small
        assert (f32.stages - 1) * stage < co_.staged_bytes(f32.bn, 4)
