"""The two-stage plain versions of the bf16 kernels for U's fused head and
kernel C, on the CPU: the order the card computes in (the head's tap
partials per channel block and phase, then their sums per output pixel; C's
partial dots and sums of squares per slice of D, then their sums) against
the JAX kernels in interpret mode, and the layouts and plans the CUDA side
checks (``conv_operands.head_plan``, ``head_weights``,
``head_workspace_shape``; ``topk_kernel.cosine_plan``). No launch on the
CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu.ops.topk_kernel import cosine_scores_pallas
from ganreverser_tpu.ops.upsample_conv_kernel import (
    upsample2_conv3x3_bn_act as j_upsample)
from ganreverser_tpu_torch.ops import (conv_operands, topk_kernel,
                                       upsample_conv_kernel as uc)
from ganreverser_tpu_torch.ops.upsample_conv import conv_nhwc

from torch_port_fixtures import one_thread  # noqa: F401

T = torch.from_numpy
# f32: sums in another order, within 1e-5 of the output's magnitude; bf16:
# U's output is rounded once to bf16 in both packages, but its f32 sums are
# taken in another order and may round to a neighbouring bf16 value, which
# the head's 9 * Co products carry on: 1e-2 of max(1, |ref|), the tolerance
# of test_torch_port_kernels.py::test_upsample_head_plain_matches_jax
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _counts():
    return (uc.upsample2_conv3x3_head.launches,
            uc.upsample2_conv3x3_bn_act.launches,
            topk_kernel.cosine_scores.launches)


def _head_inputs(rng, shape, co, cf):
    """Inputs of unit scale and weights scaled by 1/sqrt(fan-in), as a
    trained G's layers keep their outputs of order one at any width."""
    n, h, w, ci = shape
    return (rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)
             ).astype(np.float32),
            rng.uniform(0.5, 1.5, co).astype(np.float32),
            (rng.normal(size=co) * 0.1).astype(np.float32),
            (rng.normal(size=(3, 3, co, cf)) / np.sqrt(9 * co)
             ).astype(np.float32),
            (rng.normal(size=cf) * 0.1).astype(np.float32))


# (N, H, W, Ci), Co, Cf, act, final_act, dtype: Cf 1, 3 and 4; 2H x 2W off
# the head plan's tile (ragged); Co = 130 spans two channel blocks of 128
HEAD_CASES = [
    ((2, 4, 4, 8), 16, 1, "relu", "sigmoid", "float32"),
    ((2, 5, 7, 20), 40, 3, "relu", "sigmoid", "bfloat16"),
    ((1, 3, 5, 12), 130, 4, "none", "none", "float32"),
    ((2, 4, 6, 33), 130, 3, "none", "sigmoid", "bfloat16"),
    ((3, 5, 3, 16), 130, 3, "relu", "sigmoid", "float32"),
    ((2, 6, 4, 8), 24, 4, "relu", "none", "bfloat16"),
    ((1, 7, 5, 40), 72, 1, "none", "sigmoid", "bfloat16"),
    ((4, 2, 3, 5), 9, 3, "relu", "none", "float32"),
]


@pytest.mark.parametrize("shape,co,cf,act,final_act,dtype", HEAD_CASES)
def test_head_two_stage_plain_matches_jax(rng, shape, co, cf, act,
                                          final_act, dtype):
    """head_tap_partials_plain then head_finish_plain against the JAX
    kernel's fused head (final_kernel) in interpret mode, the kernels
    handed to both rounded to ``dtype`` as the fast G hands them."""
    before = _counts()
    x, k, sc, sh, fk, fb = _head_inputs(rng, shape, co, cf)
    jdt = getattr(jnp, dtype)
    xj, kj, fkj = (jnp.asarray(a).astype(jdt) for a in (x, k, fk))
    ref = np.asarray(j_upsample(xj, kj, sc, sh, act=act, tile_n=1,
                                interpret=True, final_kernel=fkj,
                                final_bias=fb, final_act=final_act
                                ).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    xt, kt, fkt = (T(np.array(a.astype(jnp.float32))).to(tdt)
                   for a in (xj, kj, fkj))
    taps = uc.head_tap_partials_plain(xt, kt, T(sc), T(sh), fkt, act=act)
    n, h, w, ci = shape
    bn = conv_operands.head_plan(h, w, ci, co, cf).bn
    assert tuple(taps.shape) == conv_operands.head_workspace_shape(
        n, h, w, co, cf, bn)
    assert taps.shape[0] == (2 if co == 130 else 1)
    out = uc.head_finish_plain(taps, T(fb), final_act=final_act, dtype=tdt)
    assert out.shape == ref.shape == (n, 2 * h, 2 * w, cf)
    assert out.dtype == tdt
    err = np.abs(out.float().numpy() - ref).max()
    scale = np.abs(ref).max() if dtype == "float32" else max(
        1.0, np.abs(ref).max())
    assert err <= TOL[dtype] * scale, err
    assert _counts() == before


@pytest.mark.parametrize("cf,rows", [(1, 16), (2, 32), (3, 32), (4, 48)])
@pytest.mark.parametrize("co", [8, 72, 130])
def test_head_weight_layout(rng, cf, rows, co):
    """(head_rows(Cf), Co') K-major: row t * Cf + f is tap t's weights into
    channel f, Co' = Co rounded up to the plan's BN, zero elsewhere."""
    assert conv_operands.head_rows(cf) == rows
    bn = conv_operands.head_plan(8, 8, 16, co, cf).bn
    fk = T((rng.normal(size=(3, 3, co, cf))).astype(np.float32))
    wk = conv_operands.head_weights(fk, torch.bfloat16, bn)
    assert wk.dtype == torch.bfloat16 and wk.is_contiguous()
    assert tuple(wk.shape) == (rows, -(-co // bn) * bn)
    for t in range(9):
        for f in range(cf):
            assert torch.equal(wk[t * cf + f, :co],
                               fk[t // 3, t % 3, :, f].to(torch.bfloat16))
    assert not wk[9 * cf:].any() and not wk[:, co:].any()


@pytest.mark.parametrize("h,w,ci,co,cf", [(32, 32, 256, 128, 3),
                                          (32, 32, 256, 128, 1),
                                          (5, 7, 20, 130, 4),
                                          (4, 4, 8, 16, 2),
                                          (16, 16, 512, 300, 3)])
def test_head_plan(h, w, ci, co, cf):
    """U's tile with BN at most 128; the head's weight tile behind the ring
    and its barriers on a 1 KB boundary; the staged f32 partials inside the
    ring; the block's bytes within the card's."""
    p = conv_operands.head_plan(h, w, ci, co, cf)
    u = conv_operands.tile_plan(h, w, ci, min(co, 128))
    assert p[:5] == u[:5] and p.bn <= conv_operands.HEAD_MAX_BN
    stage = -(-(128 * p.bk * 2 + p.bn * p.bk * 2) // 1024) * 1024
    behind = -(-p.stages * (stage + 16) // 1024) * 1024
    assert p.smem_bytes == (1024 + behind +
                            conv_operands.head_weight_bytes(p.bn, cf))
    assert p.smem_bytes <= conv_operands.MAX_SHARED_BYTES
    assert 128 * 9 * cf * 4 <= p.stages * stage


def test_head_workspace_of_main_path():
    """G3's stage 2 at N = 256 with a 3-channel head: one channel block,
    113 MB of f32 tap partials (against U's 268 MB bf16 output)."""
    p = conv_operands.head_plan(32, 32, 256, 128, 3)
    shape = conv_operands.head_workspace_shape(256, 32, 32, 128, 3, p.bn)
    assert shape == (1, 4, 256, 32, 32, 27)
    assert 4 * int(np.prod(shape)) == 113_246_208


def test_head_padding_ring_adds_nothing(rng):
    """The partials of U's output with an all-zero ring around it (the
    head's SAME padding) are zero on the ring and the tap partials inside,
    so skipping neighbours outside the image is the zero-padded conv."""
    x, k, sc, sh, fk, fb = _head_inputs(rng, (2, 4, 5, 8), 20, 3)
    xt, kt, fkt = T(x), T(k), T(fk)
    u = uc.upsample2_conv3x3_bn_act_plain(xt, kt, T(sc), T(sh), act="relu")
    ring = torch.nn.functional.pad(u, (0, 0, 1, 1, 1, 1))
    full = torch.einsum("nhwc,tcf->nhwtf", ring, fkt.reshape(9, 20, 3))
    inside = torch.zeros_like(full, dtype=torch.bool)
    inside[:, 1:-1, 1:-1] = True
    assert not full[~inside].any()
    taps = uc.head_tap_partials_plain(xt, kt, T(sc), T(sh), fkt, act="relu")
    # the workspace's phases back on the image's pixels
    v = (taps[0].reshape(2, 2, 2, 4, 5, 9, 3).permute(2, 3, 0, 4, 1, 5, 6)
         .reshape(2, 8, 10, 9, 3))
    np.testing.assert_allclose(v.numpy(), full[:, 1:-1, 1:-1].numpy(),
                               rtol=1e-6, atol=1e-6)
    out = uc.head_finish_plain(taps, T(fb), final_act="none")
    ref = conv_nhwc(u, fkt, 1, torch.float32) + T(fb)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [100, 768])
@pytest.mark.parametrize("slices", [1, 2, 5])
def test_cosine_two_stage_plain_matches_jax(rng, d, slices):
    """cosine_partials_plain then cosine_finish_plain, on the rows padded to
    the plan's D (104 for 100) as the wrapper pads them, against
    cosine_scores_pallas in interpret mode on the rows padded to a multiple
    of 128 as cosine_topk_pallas pads them; a zero row scores 0. 1e-5
    absolute (f32 sums in another order)."""
    before = _counts()
    n = 200
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb[5] = 0.0
    idx = np.array([0, 17, n - 1, 99, 5])
    padded = np.concatenate([emb, np.zeros(((-n) % 128, d), np.float32)])
    ref = np.asarray(cosine_scores_pallas(jnp.asarray(padded),
                                          jnp.asarray(idx), tile_n=128,
                                          interpret=True))[:, :n]
    plan = topk_kernel.cosine_plan(n, d, len(idx))
    e = torch.nn.functional.pad(T(emb), (0, plan.dp - d))
    slices = min(slices, -(-plan.dp // topk_kernel.BK))
    part_dot, part_sq = topk_kernel.cosine_partials_plain(e, T(idx), slices)
    assert part_dot.shape == (slices, len(idx), n)
    assert part_sq.shape == (slices, n)
    assert (part_dot.numel() + part_sq.numel() == topk_kernel.workspace_floats(
        plan._replace(slices=slices), len(idx), n))
    out = topk_kernel.cosine_finish_plain(part_dot, part_sq, T(idx))
    assert out.shape == (len(idx), n) and out.dtype == torch.float32
    assert not out[:, 5].any() and not out[4].any()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert _counts() == before


@pytest.mark.parametrize("n,d,q", [(10_000, 12_288, 10), (10_000, 100, 10),
                                   (77, 100, 3), (300, 1000, 18),
                                   (600, 64, 300), (1, 8, 1),
                                   (129, 4096, 100), (10_240, 12_288, 256),
                                   (1, 20_000, 1)])
def test_cosine_plan(n, d, q):
    """The plan covers N with 128-row tiles and Q with needle groups of a
    built width (more than 256 needles loop over grid y), pads D to a
    multiple of 8 only where D % 8 != 0, and splits D into slices of whole
    64-element chunks that cover it in order, none empty and none longer
    than MAX_SLICE_CHUNKS chunks; the ring fits the block's bytes, three
    blocks an SM up to 64 needles."""
    p = topk_kernel.cosine_plan(n, d, q)
    assert (p.dp == d) == (d % 8 == 0) and p.dp % 8 == 0 and p.dp - d < 8
    assert (p.tiles - 1) * 128 < n <= p.tiles * 128
    assert p.bnq in conv_operands.WIDTHS_N and p.bnq >= min(q, 256)
    assert (p.groups - 1) * p.bnq < q <= p.groups * p.bnq
    assert p.groups == (1 if q <= 256 else -(-q // 256))
    bounds = topk_kernel.slice_bounds(p.dp, p.slices)
    assert bounds[0][0] == 0 and bounds[-1][1] == p.dp
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0
    assert all(a % 64 == 0 and b > a for a, b in bounds)
    assert 1 <= p.slices <= -(-p.dp // 64)
    assert all(b - a <= 64 * topk_kernel.MAX_SLICE_CHUNKS for a, b in bounds)
    stage = -(-(128 * 64 * 2 + p.bnq * 64 * 2) // 1024) * 1024
    assert p.smem_bytes == 1024 + p.stages * (stage + 16)
    assert p.stages >= 2
    per_sm = 3 if p.bnq <= 64 else 1
    assert per_sm * (p.smem_bytes + 1024) <= 233_472
    depth = -(-p.dp // (64 * topk_kernel.MAX_SLICE_CHUNKS))
    if p.slices > max(1, depth):  # else only as far as one resident wave
        assert p.tiles * p.groups * p.slices <= 132 * per_sm
    assert topk_kernel.workspace_floats(p, q, n) == p.slices * (q * n + n)


def test_cosine_plan_of_main_path():
    """apply_r's two searches at N = 10,000 and 10 needles: the pixel
    search in 5 slices (395 blocks, one wave at three an SM), the attribute
    search's D = 100 padded to 104 in its 2 chunks."""
    pix = topk_kernel.cosine_plan(10_000, 12_288, 10)
    assert (pix.dp, pix.bnq, pix.tiles, pix.groups, pix.slices) == (
        12_288, 16, 79, 1, 5)
    att = topk_kernel.cosine_plan(10_000, 100, 10)
    assert (att.dp, att.slices) == (104, 2)


def test_cosine_plan_of_e2e_program():
    """The fused e2e program's searches at N = 10,240 in needle chunks of
    256: the pixel search's D = 12,288 in 3 slices of 64 chunks (the
    depth cap; the wave alone gives 1), the attributes' padded D in one
    (80 blocks of 256 needles fill the wave)."""
    pix = topk_kernel.cosine_plan(10_240, 12_288, 256)
    assert (pix.bnq, pix.tiles, pix.groups, pix.slices) == (256, 80, 1, 3)
    att = topk_kernel.cosine_plan(10_240, 100, 256)
    assert (att.dp, att.bnq, att.slices) == (104, 256, 1)
