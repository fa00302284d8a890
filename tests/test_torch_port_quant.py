"""The int8 legs (ganreverser_tpu_torch/ops/quant.py, the int8 fast G and R
of models/fastpath.py, apply_r --int8) and the kernels' custom operators
(ops/library.py) against the JAX package on the CPU: the same numpy
inputs, the JAX side through ganreverser_tpu/ops/quant.py and its int8
fast paths (XLA on the CPU, as tests/test_quant.py runs them).

Tolerances: the quantisers, the int32 sums and the dequantised outputs of
quant_conv3x3_same, quant_dense and the int8 phase conv are bitwise JAX's
jitted functions (int8 x int8 -> int32 has no rounding; the epilogue is one
f32 rounding of f32(acc) * (s_x * s_w) + b on both sides: XLA fuses the
multiply and the add into one FMA inside a jitted program, as the JAX int8
paths all are, where op-by-op it rounds twice); an activation after them
within
1e-6 of the scale (expm1 and the sigmoid in another library); the whole
int8 G and R within two int8 levels of the output's scale (2 max|out| /
127) on one batch. An activation that lands on a rounding boundary in one
framework may quantise one level apart in the other: the two differ by
ulps before any quantisation (XLA's rsqrt in the BatchNorm fold is not
correctly rounded, expm1 and the sigmoid come from other libraries, and
XLA decides per program where it fuses a multiply and an add into an
FMA), and a flipped level spreads through the layers after it, through
the per-tensor scales too. So apply_r --int8's latents over 300 faces
are held within 8 levels anywhere and half a level on average, its
images (G alone) within 2."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ganreverser_tpu import analysis as JA
from ganreverser_tpu import io as gio
from ganreverser_tpu import models as M
from ganreverser_tpu.cli import apply_r as j_apply_r
from ganreverser_tpu.models import fastpath as JF
from ganreverser_tpu.ops import quant as JQ
from ganreverser_tpu_torch.analysis.batched import forward_batched
from ganreverser_tpu_torch.cli import apply_r
from ganreverser_tpu_torch.core.prng import noise_inputs, stage_generator
from ganreverser_tpu_torch.models import bridge, fastpath
from ganreverser_tpu_torch.ops import conv_operands as CO
from ganreverser_tpu_torch.ops import cuda_lib, dense_kernel, library
from ganreverser_tpu_torch.ops import quant as Q

from torch_port_fixtures import one_thread  # noqa: F401

T = torch.from_numpy


def _same(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_array_equal(port, ref)


def _levels(port, ref, n=2.0, mean=None):
    """|port - ref| within ``n`` int8 levels of ``ref``'s scale (max |ref| /
    127) everywhere, and with ``mean`` within that many on average."""
    ref = np.asarray(ref, np.float32)
    lev = np.abs(np.asarray(port, np.float32) - ref) / (
        np.abs(ref).max() / 127.0)
    assert lev.max() <= n, lev.max()
    assert mean is None or lev.mean() <= mean, lev.mean()


def _boundary_input(rng):
    """Values at exact .5 steps of the grid (scale 1/16 exactly: the max is
    127/16), zeros, both signs, the max and its negation."""
    halves = (rng.integers(-126, 126, size=40) + 0.5) / 16.0
    x = np.concatenate([[127 / 16, -127 / 16, 0.0, -0.0, 0.5 / 16,
                         -0.5 / 16, 1.5 / 16, -1.5 / 16], halves,
                        rng.normal(size=16)])
    return x.astype(np.float32).reshape(8, 8)


@pytest.mark.parametrize("axis", [None, (0, 1, 2), (0,)])
def test_quantize_symmetric_matches_jax(rng, axis):
    """Per tensor (kernel Q4's plain version) and per slice: q and the
    scale bitwise JAX's, half steps rounded to even, q never -128."""
    if axis == (0, 1, 2):
        x = (rng.normal(size=(3, 3, 5, 7)) * rng.uniform(0.01, 10, 7)
             ).astype(np.float32)
        x[:, :, :, 0] = 0.0  # an all-zero channel: scale eps / 127
    else:
        x = _boundary_input(rng)
    q, s = Q.quantize_symmetric(T(x), axis)
    jq, js = JQ.quantize_symmetric(jnp.asarray(x), axis)
    _same(q, jq)
    _same(s, js)
    assert q.min().item() >= -127 and q.max().item() <= 127
    if axis is None:
        assert s.shape == () and s.item() == 1 / 16
        halves = np.abs(x.reshape(-1) * 16) % 1 == 0.5
        assert (np.asarray(q).reshape(-1)[halves] % 2 == 0).all()


def test_fold_quantize_matches_jax(rng):
    k = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    sc = rng.uniform(0.1, 10, 6).astype(np.float32)
    sh = rng.normal(size=6).astype(np.float32)
    for port, ref in zip(Q.fold_quantize_conv(T(k), T(sc), T(sh)),
                         JQ.fold_quantize_conv(jnp.asarray(k),
                                               jnp.asarray(sc),
                                               jnp.asarray(sh))):
        _same(port, ref)
    kd = rng.normal(size=(9, 5)).astype(np.float32)
    for port, ref in zip(Q.fold_quantize_dense(T(kd), T(sc[:5]), T(sh[:5])),
                         JQ.fold_quantize_dense(jnp.asarray(kd),
                                                jnp.asarray(sc[:5]),
                                                jnp.asarray(sh[:5]))):
        _same(port, ref)


def _quantized(rng, x_shape, w_shape, w_axes):
    x = rng.normal(size=x_shape).astype(np.float32)
    w = (rng.normal(size=w_shape) * 0.3).astype(np.float32)
    b = rng.normal(size=w_shape[-1]).astype(np.float32)
    xq, xs = JQ.quant_act(jnp.asarray(x))
    wq, ws = JQ.quantize_symmetric(jnp.asarray(w), axis=w_axes)
    return [np.asarray(a) for a in (xq, xs, wq, ws)] + [b]


def test_quant_conv3x3_same_matches_jax(rng):
    """Q1's plain version: the int32 sums and the dequantised output bitwise
    JAX's; with ELU and the fused pool within 1e-6 of JAX's ELU then
    reduce_window."""
    xq, xs, wq, ws, b = _quantized(rng, (2, 6, 8, 7), (3, 3, 7, 5),
                                   (0, 1, 2))
    acc = lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    _same(Q.conv3x3_int32_plain(T(xq), T(wq)), acc)
    ref = jax.jit(JQ.quant_conv3x3_same)(*map(jnp.asarray,
                                               (xq, xs, wq, ws, b)))
    _same(Q.quant_conv3x3_same(*map(T, (xq, xs, wq, ws, b))), ref)
    pooled = lax.reduce_window(jax.nn.elu(ref), -jnp.inf, lax.max,
                               (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    got = Q.quant_conv3x3_same(*map(T, (xq, xs, wq, ws, b)), act="elu",
                               pool=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pooled), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(pooled)).max())


def test_quant_dense_matches_jax(rng):
    xq, xs, wq, ws, b = _quantized(rng, (5, 12), (12, 7), (0,))
    ws = ws.reshape(1, -1)
    _same(Q.dense_int32_plain(T(xq), T(wq)),
          lax.dot_general(jnp.asarray(xq), jnp.asarray(wq),
                          (((1,), (0,)), ((), ())),
                          preferred_element_type=jnp.int32))
    _same(Q.quant_dense(*map(T, (xq, xs, wq, ws, b))),
          jax.jit(JQ.quant_dense)(*map(jnp.asarray, (xq, xs, wq, ws, b))))


def test_int8_phase_conv_matches_jax(rng):
    """G's int8 upsample stage: the 16 phase taps quantised per channel are
    the JAX package's 4x4 lhs-dilated kernel (tap [a, ta, b, tb] its
    [2 ta + a, 2 tb + b]) bitwise, and the phase convs' int32 sums and the
    dequantised ReLU output are bitwise its lhs-dilated int8 conv's
    (models/fastpath.py::make_fast_generator_xla_int8)."""
    k = (rng.normal(size=(3, 3, 6, 5)) * 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    shift = rng.normal(size=5).astype(np.float32)
    x = np.maximum(rng.normal(size=(2, 4, 3, 6)), 0).astype(np.float32)
    # the JAX package's stage, as make_fast_generator_xla_int8 writes it
    a = jnp.asarray([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0],
                     [0.0, 1.0, 1.0], [0.0, 0.0, 1.0]], jnp.float32)
    wf = jnp.asarray(k) * jnp.asarray(scale)[None, None, None, :]
    w4 = jnp.einsum("bx,axio->abio", a, jnp.einsum("ay,yxio->axio", a, wf))
    jwq, jws = JQ.quantize_symmetric(w4, axis=(0, 1, 2))
    xq, xs = JQ.quant_act(jnp.asarray(x))

    @jax.jit
    def stage(xq, xs, jwq, jws, shift):
        acc = lax.conv_general_dilated(
            xq, jwq, (1, 1), ((2, 2), (2, 2)), lhs_dilation=(2, 2),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        return acc, jnp.maximum(acc.astype(jnp.float32) * (xs * jws).reshape(
            1, 1, 1, -1) + shift, 0.0)
    acc, ref = stage(xq, xs, jwq, jws, jnp.asarray(shift))

    wq16, ws = Q.quant_phase_weights(T(k), T(scale))
    _same(ws, np.asarray(jws).reshape(-1))
    _same(wq16.permute(1, 0, 3, 2, 4, 5).reshape(4, 4, 6, 5),
          jwq)  # [a, ta, b, tb] -> [ta, a, tb, b] = [2 ta + a, 2 tb + b]
    xq_t = T(np.asarray(xq))
    _same(Q.phase_conv_int32_plain(xq_t, wq16), acc)
    _same(Q.quant_upsample2_conv3x3(xq_t, T(np.asarray(xs)), wq16, ws,
                                    T(shift)), ref)


def _int8(rng, shape):
    """int8 values over the whole symmetric grid, [-127, 127]."""
    return T(rng.integers(-127, 128, size=shape).astype(np.int8))


@pytest.mark.parametrize("co", [3, 70, 256])
@pytest.mark.parametrize("ci,cp", [(3, 32), (5, 32), (64, 64), (130, 144)])
def test_s8_operands_unpack_to_the_weights(rng, ci, cp, co):
    """Q1's and Q2's operands, (taps, Co, Ci') int8 K-major: tap t of
    conv_operand is wq[t // 3, t % 3] and tap ((a * 2 + ta) * 2 + b) * 2 +
    tb of phase_operand is wq16[a, ta, b, tb], transposed; Ci' the rows of
    32, 64 or a multiple of 16 bytes, the padded channels zero."""
    wq, wq16 = _int8(rng, (3, 3, ci, co)), _int8(rng, (2, 2, 2, 2, ci, co))
    assert CO.padded_channels(ci, 1) == cp
    for op, taps in ((Q.conv_operand(wq), wq.reshape(9, ci, co)),
                     (Q.phase_operand(wq16), wq16.reshape(16, ci, co))):
        assert op.dtype == torch.int8 and op.is_contiguous()
        assert tuple(op.shape) == (taps.shape[0], co, cp)
        assert torch.equal(op[..., :ci].transpose(1, 2), taps)
        assert not op[..., ci:].any()
    assert Q.conv_operand(wq)[4, 7 % co, 1].item() == wq[1, 1, 1, 7 % co]
    assert Q.phase_operand(wq16)[11, 2, 0].item() == wq16[1, 0, 1, 1, 0, 2]


@pytest.mark.parametrize("n,h,w,ci,co", [(2, 5, 7, 3, 70), (1, 9, 17, 40, 3),
                                         (1, 3, 4, 130, 19),
                                         (2, 4, 6, 64, 5)])
def test_s8_sums_in_kernel_order_are_exact(rng, n, h, w, ci, co):
    """The tensor-core tile's s32 sums in its K order (each tap, then each
    BK chunk of the padded K-major operands; s8_sums_plain) are exactly the
    int32 convolutions' (conv3x3_int32_plain, JAX's int8 conv, and
    phase_conv_int32_plain), on ragged shapes, at the grid's extremes (the
    sums pass 2^24, what f32 holds exactly)."""
    xq, wq = _int8(rng, (n, h, w, ci)), _int8(rng, (3, 3, ci, co))
    wq16 = _int8(rng, (2, 2, 2, 2, ci, co))
    xq[0, 0, 0] = wq[..., 0].flatten()[0] = 127
    bk = CO.tile_plan(h, w, ci, co, out_bytes=4, elem_bytes=1).bk
    got = Q.s8_sums_plain(xq, Q.conv_operand(wq), bk)
    assert got.dtype == torch.int32
    assert torch.equal(got, Q.conv3x3_int32_plain(xq, wq))
    _same(got, lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    assert torch.equal(
        Q.s8_sums_plain(xq, Q.phase_operand(wq16), bk, phases=True),
        Q.phase_conv_int32_plain(xq, wq16))


# the int8 layers of G3 and R at 3x64x64 (H, W, Ci, Co at the input's
# resolution: R's six convs, G's output conv, G's two upsample stages), and
# the ragged shapes of chip_smoke's phase 10 and the card tests
S8_PLAN_SHAPES = [(64, 64, 3, 64), (64, 64, 64, 64), (32, 32, 64, 128),
                  (32, 32, 128, 128), (64, 64, 128, 3), (16, 16, 512, 256),
                  (32, 32, 256, 128), (13, 21, 40, 70), (10, 18, 5, 3),
                  (13, 21, 130, 300), (6, 10, 70, 130), (5, 7, 40, 130),
                  (9, 17, 130, 300), (3, 5, 5, 3), (9, 13, 40, 130)]


@pytest.mark.parametrize("h,w,ci,co", S8_PLAN_SHAPES)
def test_s8_tile_plan(h, w, ci, co):
    """The int8 plan (elem_bytes 1, f32 output): BK rows of 32, 64 or 128
    bytes (the padded channels where they are 32 or 64, else 128), BN the least width covering Co (256
    and more channel blocks above), the ring holding the f32 staged tile,
    the shared bytes its layout's (csrc/conv_wgmma.cuh::plan_ok) within
    what a block may use."""
    p = CO.tile_plan(h, w, ci, co, out_bytes=4, elem_bytes=1)
    cp = CO.padded_channels(ci, 1)
    assert p.bk in (32, 64, 128) and p.bk == (cp if cp <= 64 else 128)
    assert cp >= ci and cp % 16 == 0 and (cp in (32, 64) or cp > 64)
    assert p.bn == next((b for b in CO.WIDTHS_N if co <= b), 256)
    assert p.bh * p.bw == CO.BM and p.bh % 2 == 0 and p.bw % 2 == 0
    stage = -(-(CO.BM + p.bn) * p.bk // CO.ALIGN) * CO.ALIGN
    assert CO.staged_bytes(p.bn, 4) <= p.stages * stage
    assert p.stages >= 2
    assert p.smem_bytes == CO.ALIGN + p.stages * (stage + 16)
    assert p.smem_bytes <= CO.MAX_SHARED_BYTES
    if (h, w, ci, co) == (16, 16, 512, 256):  # G's stage 1: 133 KB staged
        assert CO.staged_bytes(256, 4) == 133_120 and p.bk == 128


# Q3's shapes: the int8 legs' G l0, R l27 and R l31 at batch 256, and
# ragged ones; (N, K, M)
DENSE_SHAPES = [(256, 100, 131072), (256, 32768, 512), (256, 512, 100),
                (7, 10, 13), (70, 4096, 130), (1, 40, 300)]


@pytest.mark.parametrize("n,k,m", DENSE_SHAPES)
def test_dense_operand_and_split_plan(rng, n, k, m):
    """Q3's K-major operand (M, K') unpacks to the weights, the padding
    zero; its plan fits csrc/conv_wgmma.cuh's layout (1 x 128 rows, the
    f32 staged tile in the ring) and its K splits, a divisor of the K
    chunks, cover K' exactly once; R l27 splits 16 ways over its 8 tiles
    of BN 128, G l0 and R l31 not at all, R l31's short K narrowing its
    tiles to BN 16 instead."""
    wq = _int8(rng, (k, m))
    op = Q.dense_operand(wq)
    kp = CO.padded_channels(k, 1)
    assert op.dtype == torch.int8 and op.is_contiguous()
    assert tuple(op.shape) == (m, kp)
    assert torch.equal(op[:, :k].T, wq) and not op[:, k:].any()
    plan, splits = Q.dense_plan(n, k, m)
    assert (plan.bh, plan.bw) == (1, CO.BM) and plan.bn <= Q.DENSE_MAX_BN
    assert plan.bk == (kp if kp <= 64 else 128)
    chunks = -(-kp // plan.bk)
    assert chunks % splits == 0 and chunks // splits >= min(
        chunks, Q.DENSE_MIN_CHUNKS)
    stage = -(-(CO.BM + plan.bn) * plan.bk // CO.ALIGN) * CO.ALIGN
    assert CO.staged_bytes(plan.bn, 4) <= plan.stages * stage
    assert plan.smem_bytes == CO.ALIGN + plan.stages * (stage + 16)
    assert plan.smem_bytes <= CO.MAX_SHARED_BYTES
    covered = np.zeros(kp, np.int64)
    for k0, k1 in Q.dense_k_ranges(k, plan, splits):
        covered[k0:k1] += 1
    assert (covered == 1).all()
    want = {(256, 32768, 512): (16, 128), (256, 100, 131072): (1, 128),
            (256, 512, 100): (1, 16)}
    assert (splits, plan.bn) == want.get((n, k, m), (splits, plan.bn))


@pytest.mark.parametrize("n,k,m", [(7, 10, 13), (70, 4096, 130),
                                   (3, 600, 5)])
def test_dense_sums_in_kernel_order_are_exact(rng, n, k, m):
    """Q3's s32 sums split by split as the kernel takes them
    (dense_sums_plain) are exactly the int32 product, at the grid's
    extremes; and JAX's int8 dot_general's."""
    xq, wq = _int8(rng, (n, k)), _int8(rng, (k, m))
    xq[0] = 127
    wq[:, 0] = 127
    plan, splits = Q.dense_plan(n, k, m)
    got = Q.dense_sums_plain(xq, Q.dense_operand(wq), plan, splits)
    assert got.dtype == torch.int32
    assert torch.equal(got, Q.dense_int32_plain(xq, wq))
    _same(got, lax.dot_general(jnp.asarray(xq.numpy()),
                               jnp.asarray(wq.numpy()),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32))


def _producer_case(rng, kind):
    """(a call of the producer ``kind`` on quantised numpy inputs, taking
    ``with_max``, and its plain version's)."""
    if kind == "dense":
        xq, xs, wq, ws, b = _quantized(rng, (5, 40), (40, 9), (0,))
        args = [T(a) for a in (xq, xs, wq, ws.reshape(-1), b)]
        return (lambda **kw: Q.quant_dense(*args, act="elu", **kw),
                lambda **kw: Q.quant_dense_plain(*args, act="elu", **kw))
    if kind == "phase":
        xq, xs, _, _, sh = _quantized(rng, (2, 3, 5, 6), (3, 3, 6, 4),
                                      (0, 1, 2))
        wq16, ws = Q.quant_phase_weights(
            T((rng.normal(size=(3, 3, 6, 4)) * 0.3).astype(np.float32)),
            T(rng.uniform(0.5, 1.5, 4).astype(np.float32)))
        args = [T(xq), T(xs), wq16, ws, T(sh)]
        return (lambda **kw: Q.quant_upsample2_conv3x3(*args, **kw),
                lambda **kw: Q.quant_upsample2_conv3x3_plain(*args, **kw))
    pool = kind == "conv+pool"
    xq, xs, wq, ws, b = _quantized(rng, (2, 6, 8, 7), (3, 3, 7, 5),
                                   (0, 1, 2))
    args = [T(a) for a in (xq, xs, wq, ws, b)]
    return (lambda **kw: Q.quant_conv3x3_same(*args, act="elu", pool=pool,
                                              **kw),
            lambda **kw: Q.quant_conv3x3_plain(*args, act="elu", pool=pool,
                                               **kw))


@pytest.mark.parametrize("kind", ["conv", "conv+pool", "phase", "dense"])
def test_producer_max_and_one_pass_quantiser_match_jax(rng, kind):
    """Each int8 producer (Q1 with and without the pool, Q2, Q3) called
    ``with_max`` returns its output unchanged and max |y| of exactly that
    output, through the operator and through its plain version; Q4's one
    pass from that max (quant_act_max) gives (q, scale) bitwise JAX's
    quantize_symmetric of the output, and quantize_plain's."""
    call, plain = _producer_case(rng, kind)
    y, m = call(with_max=True)
    assert torch.equal(y, call()) and m.shape == () and m.dtype == y.dtype
    assert torch.equal(m, y.abs().amax())
    py, pm = plain(with_max=True)
    assert torch.equal(py, y) and torch.equal(pm, m)
    q, s = Q.quant_act_max(y, m)
    jq, js = JQ.quantize_symmetric(jnp.asarray(y.numpy()), None)
    _same(q, jq)
    _same(s, js)
    qp, sp = Q.quantize_plain(y)
    assert torch.equal(q, qp) and torch.equal(s, sp)


def test_one_pass_quantiser_plain_at_the_grid_edges(rng):
    """quantize_with_max_plain from the max: half steps to even, the max
    and its negation to +-127, the scale the correctly rounded max / 127
    (IEEE division, which CUDA's division by a number is not), an all-zero
    tensor to the 1e-12 floor; a
    NaN in x makes quantize_plain's max NaN (the kernels leave it out of
    theirs, ROADMAP queue C), which the one-pass plain version carries
    into its scale."""
    x = T(_boundary_input(rng))
    q, s = Q.quantize_with_max_plain(x, x.abs().amax())
    qp, sp = Q.quantize_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp) and s.item() == 1 / 16
    m = np.float32(182.19723510742188)  # where a reciprocal is 1 ulp off
    y = T(np.array([m, -3.0, 50.92914581298828], np.float32))
    for _, s in (Q.quantize_plain(y),
                 Q.quantize_with_max_plain(y, y.abs().amax())):
        assert s.item() == np.float32(np.float64(m) / 127.0)
    z = torch.zeros(3, 4)
    q0, s0 = Q.quantize_with_max_plain(z, z.abs().amax())
    assert not q0.any() and s0.item() == np.float32(1e-12) / np.float32(127)
    x[0, 1] = float("nan")
    assert torch.isnan(Q.quantize_plain(x)[1])
    assert torch.isnan(Q.quantize_with_max_plain(x, x.abs().amax())[1])


def test_int8_forwards_quantise_each_producer_once(monkeypatch, rng):
    """The int8 G and R quantise their first inputs (z, the images) with
    Q4's two launches and every other layer's input in one pass from the
    max its producer returned: 2 and 10 calls a forward pair."""
    calls = {"quant_act": 0, "quant_act_max": 0}
    for name in calls:
        fn = getattr(Q, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(Q, name, counted)
    dims, nd = (1, 8, 8), 4
    rv = bridge.to_torch(_variables(M.create_R(dims, nd, "normal"),
                                    (8, 8, 1), 5, rng), "cpu")
    gv = bridge.to_torch(_variables(M.create_G(dims, nd), (nd,), 6, rng),
                         "cpu")
    images = fastpath.make_fast_generator_int8(dims, nd, torch.float32)(
        gv, T(rng.normal(size=(3, nd)).astype(np.float32)))
    fastpath.make_fast_inverter_int8(dims, nd, "normal", torch.float32)(
        rv, images)
    assert calls == {"quant_act": 2, "quant_act_max": 10}


def _variables(model, in_shape, seed, rng, amplify=4.0):
    """JAX variables with non-trivial BatchNorm statistics, the kernels
    scaled by ``amplify``, as numpy."""
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


@pytest.mark.parametrize("dims,nd,noise_method", [((3, 16, 16), 8, "normal"),
                                                  ((1, 8, 8), 4, "uniform")])
def test_int8_fast_forwards_match_jax(rng, dims, nd, noise_method):
    """The int8 fast R and G against JAX's make_fast_inverter_int8 and
    make_fast_generator_xla_int8 on the same weights and inputs, f32
    output, within two int8 levels of the output's scale; no kernel
    launches on the CPU."""
    c, h, w = dims
    before = cuda_lib.launch_counts()
    R = M.create_R(dims, nd, noise_method)
    G = M.create_G(dims, nd)
    rv, gv = _variables(R, (h, w, c), 3, rng), _variables(G, (nd,), 4, rng)
    images = rng.uniform(size=(5, h, w, c)).astype(np.float32)
    z = rng.normal(size=(5, nd)).astype(np.float32)
    jr = JF.make_fast_inverter_int8(dims, nd, noise_method,
                                    jnp.float32)(rv, images)
    jg = JF.make_fast_generator_xla_int8(dims, nd, jnp.float32)(gv, z)
    tr = fastpath.make_fast_inverter_int8(dims, nd, noise_method,
                                          torch.float32)(
        bridge.to_torch(rv, "cpu"), T(images))
    tg = fastpath.make_fast_generator_int8(dims, nd, torch.float32)(
        bridge.to_torch(gv, "cpu"), T(z))
    assert tr.shape == (5, nd) and tg.shape == (5, h, w, c)
    _levels(tr, jr)
    _levels(tg, jg)
    assert cuda_lib.launch_counts() == before


def _ops_samples():
    """A CPU sample of every registered operator's arguments."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 4, 6, 3, generator=g)
    k = torch.randn(3, 3, 3, 5, generator=g) * 0.3
    k2 = torch.randn(3, 3, 5, 4, generator=g) * 0.3
    sc, sh = torch.rand(5, generator=g) + 0.5, torch.randn(5, generator=g)
    fk, fb = torch.randn(3, 3, 5, 3, generator=g), torch.randn(3, generator=g)
    xq, xs = Q.quantize_plain(torch.randn(2, 4, 6, 3, generator=g))
    wq, ws = Q.quantize_plain(k, axis=(0, 1, 2))
    wq16, ws16 = Q.quant_phase_weights(k, sc)
    dq, dsc = Q.quantize_plain(torch.randn(4, 8, generator=g), axis=(0,))
    return {
        "conv_block": (x, [k, k2], [sc, sc[:4]], [sh, sh[:4]], "elu", True,
                       None),
        "upsample2_conv3x3_bn_act": (x, k, sc, sh, "relu", None),
        "upsample2_conv3x3_head": (x, k, sc, sh, fk, fb, "relu", "sigmoid",
                                   None, None),
        # kernel D at a padded K (100 -> 104), each activation it takes
        "dense_act": [(torch.randn(3, 100, generator=g),
                       dense_kernel.dense_operand(
                           torch.randn(100, 6, generator=g)),
                       torch.randn(6, generator=g), act)
                      for act in dense_kernel.ACTS],
        "cosine_scores": (torch.randn(7, 5, generator=g),
                          torch.tensor([0, 3])),
        "approx_topk": (torch.randn(3, 40, generator=g), 5, 0.95),
        "quantize_act": (torch.randn(3, 5, generator=g),),
        "quantize_act_max": (xq.float(), xq.float().abs().amax()),
        # the int8 producers with and without their max
        "quant_conv3x3": [(xq, xs, wq, ws.reshape(-1), sh, "elu", True,
                           with_max, None) for with_max in (False, True)],
        "quant_upsample2_conv3x3": [(xq, xs, wq16, ws16, sh, "relu",
                                     with_max, None)
                                    for with_max in (False, True)],
        "quant_dense": [(torch.randint(-127, 128, (3, 4), generator=g,
                                       dtype=torch.int8), xs, dq,
                         dsc.reshape(-1), torch.randn(8, generator=g), "elu",
                         with_max, None) for with_max in (False, True)],
    }


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_custom_op_passes_opcheck(name):
    """torch.library.opcheck on every registered operator, each signature
    (the int8 producers with and without their max, kernel D with each
    activation): schema, fake implementation against the real one, no
    aliasing of an input."""
    samples = _ops_samples()[name]
    for args in samples if isinstance(samples, list) else [samples]:
        torch.library.opcheck(getattr(torch.ops.ganreverser, name).default,
                              args)


def test_quant_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 4, 4, dtype=torch.int8, device="meta")
    s = torch.zeros((), device="meta")
    w = torch.zeros(3, 3, 4, 2, dtype=torch.int8, device="meta")
    c = torch.zeros(2, device="meta")
    with pytest.raises(ValueError):
        Q.quant_act(torch.zeros(3, device="meta"))
    with pytest.raises(ValueError):
        Q.quant_conv3x3_same(x, s, w, c, c)
    with pytest.raises(ValueError):  # mixed devices
        Q.quant_dense(torch.zeros(2, 4, dtype=torch.int8), torch.zeros(()),
                      torch.zeros(4, 2, dtype=torch.int8), c, c)
    with pytest.raises(ValueError):
        Q.quant_conv3x3_same(x, s, w, c, c, act="tanh")


def _write_checkpoints(save, rng, dims, nd):
    c, h, w = dims
    cfg = {"noiseDim": nd, "noiseMethod": "normal", "colorSpace": "y",
           "height": h, "width": w}
    G, R = M.create_G(dims, nd), M.create_R(dims, nd, "normal")
    gio.save_checkpoint(gio.adversarial_name(save),
                        {"G": _variables(G, (nd,), 8, rng), "D": {}},
                        config=cfg)
    gio.save_checkpoint(gio.r_name(save, c, h, w, nd, "normal", False),
                        {"R": _variables(R, (h, w, c), 9, rng)}, config=cfg)


def test_apply_r_int8_matches_jax(tmp_path, rng, capsys):
    """apply_r --int8 against the JAX CLI's --int8 on the same JAX-written
    checkpoints: the same artifacts, and stage ②'s latents within two int8
    levels of JAX's int8 G and R run over the port's noise in the CLI's
    chunks (the two frameworks draw other noise); the six stages run."""
    dims, nd, n = (1, 8, 8), 6, 300
    save = str(tmp_path / "logs")
    _write_checkpoints(save, rng, dims, nd)
    g = os.path.join(save, "adversarial")
    args = ["--N", str(n), "--needles", "2", "--batchSize", "64",
            "--clusters", "3", "--kmeans_iters", "3", "--anomalies_n", "128",
            "--int8"]
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "port")
    j_apply_r.main(["--G", g, "--save", save, "--writeto", j_out, *args])
    capsys.readouterr()
    result = apply_r.main(["--G", g, "--save", save, "--writeto", t_out,
                           *args])
    printed = capsys.readouterr().out
    assert "not ported yet" not in printed and "int8 G and R" in printed
    for stage in "①②③④⑤⑥":
        assert f"stage {stage}" in printed

    def files(d):
        return {f for f in os.listdir(d) if not f.startswith("cluster_")}
    assert files(t_out) == files(j_out)

    batch = 256  # max(--batchSize, 256), the per-tensor scales' chunk
    noise = noise_inputs(stage_generator(1, 2, "cpu"), n, nd, "normal",
                         device="cpu").numpy()
    gv = {"params": gio.load_checkpoint(g)[0]["G"]["params"],
          "state": gio.load_checkpoint(g)[0]["G"]["state"]}
    rtree = gio.load_checkpoint(gio.r_name(save, 1, 8, 8, nd, "normal",
                                           False))[0]["R"]
    jgen = JF.make_fast_generator_xla_int8(dims, nd, jnp.float32)
    jinv = JF.make_fast_inverter_int8(dims, nd, "normal", jnp.float32)
    j_images = JA.forward_batched(lambda b: jgen(gv, b), jnp.asarray(noise),
                                  batch)
    j_z = JA.forward_batched(lambda b: jinv(rtree, b), j_images, batch)
    _levels(result["images"].numpy(), j_images)
    _levels(result["attributes"].numpy(), j_z, 8.0, mean=0.5)


def test_int8_batched_matches_port_chunks(rng):
    """The int8 R over chunks: forward_batched pads the last chunk with its
    last row, and each chunk's activation scale is its own."""
    dims, nd = (1, 8, 8), 4
    R = M.create_R(dims, nd, "normal")
    rv = bridge.to_torch(_variables(R, (8, 8, 1), 5, rng), "cpu")
    inv = fastpath.make_fast_inverter_int8(dims, nd, "normal", torch.float32)
    x = T(rng.uniform(size=(10, 8, 8, 1)).astype(np.float32))
    out = forward_batched(lambda b: inv(rv, b), x, 4)
    last = torch.cat([x[8:], x[9:].expand(2, 8, 8, 1)])
    assert torch.equal(out[:4], inv(rv, x[:4]))
    assert torch.equal(out[8:], inv(rv, last)[:2])
