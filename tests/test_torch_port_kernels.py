"""Each ported kernel's plain version against its JAX function, the Pallas
kernels running in interpret mode on the CPU as the JAX package's own tests
run them. f32 throughout; tolerances 2e-5 to 1e-4 (f32 sums in another
order). On CPU tensors the wrappers take the plain version and launch
nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu.ops.conv_block_kernel import conv_block as j_conv_block
from ganreverser_tpu.ops.conv_kernel import fold_batchnorm as j_fold
from ganreverser_tpu.ops.topk_kernel import cosine_scores_pallas
from ganreverser_tpu.ops.upsample_conv_kernel import (
    phase_kernels as j_phase_kernels,
    upsample2_conv3x3_bn_act as j_upsample)
from ganreverser_tpu_torch.ops import (conv_block_kernel, topk_kernel,
                                       upsample_conv_kernel)
from ganreverser_tpu_torch.ops.conv_kernel import fold_batchnorm

T = torch.from_numpy


def _launch_counts():
    return (conv_block_kernel.conv_block.launches,
            upsample_conv_kernel.upsample2_conv3x3_bn_act.launches,
            topk_kernel.cosine_scores.launches)


def test_fold_batchnorm_matches_jax(rng):
    p = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
         "bias": rng.normal(size=6).astype(np.float32)}
    s = {"mean": rng.normal(size=6).astype(np.float32),
         "var": rng.uniform(0.2, 2.0, 6).astype(np.float32)}
    bias = rng.normal(size=6).astype(np.float32)
    ref = j_fold(p, s, bias)
    out = fold_batchnorm({k: T(v) for k, v in p.items()},
                         {k: T(v) for k, v in s.items()}, T(bias))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)


def _chain(rng, chans):
    kernels, scales, shifts = [], [], []
    for ci, co in zip(chans[:-1], chans[1:]):
        kernels.append((rng.normal(size=(3, 3, ci, co)) * 0.3).astype(np.float32))
        scales.append(rng.uniform(0.5, 1.5, co).astype(np.float32))
        shifts.append((rng.normal(size=co) * 0.2).astype(np.float32))
    return kernels, scales, shifts


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("act", ["elu", "relu"])
def test_conv_block_plain_matches_jax(rng, pool, act):
    before = _launch_counts()
    x = rng.normal(size=(3, 8, 6, 5)).astype(np.float32)
    kernels, scales, shifts = _chain(rng, [5, 8, 8, 7])
    ref = np.asarray(j_conv_block(x, tuple(kernels), tuple(scales),
                                  tuple(shifts), act=act, pool=pool,
                                  tile_n=1))
    out = conv_block_kernel.conv_block(T(x), [T(k) for k in kernels],
                                       [T(s) for s in scales],
                                       [T(s) for s in shifts], act=act,
                                       pool=pool)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert _launch_counts() == before


def test_phase_kernels_match_jax(rng):
    k = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        upsample_conv_kernel.phase_kernels(T(k)).numpy(),
        np.asarray(j_phase_kernels(jnp.asarray(k))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "none", "sigmoid"])
def test_upsample_plain_matches_jax(rng, act):
    before = _launch_counts()
    x = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 6, 9)) * 0.3).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, 9).astype(np.float32)
    sh = rng.normal(size=9).astype(np.float32)
    ref = np.asarray(j_upsample(x, k, sc, sh, act=act, tile_n=1))
    out = upsample_conv_kernel.upsample2_conv3x3_bn_act(T(x), T(k), T(sc),
                                                        T(sh), act=act)
    assert out.shape == ref.shape == (2, 8, 10, 9)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert _launch_counts() == before


@pytest.mark.parametrize("n,d", [(256, 100), (200, 2000)])
def test_cosine_scores_plain_matches_jax(rng, n, d):
    """D=100 (latents) and a wide D with N not a multiple of 128: the JAX
    kernel gets the zero-padded rows cosine_topk_pallas gives it, the port
    takes N as it is."""
    before = _launch_counts()
    emb = rng.normal(size=(n, d)).astype(np.float32)
    idx = np.array([0, 17, n - 1, 99])
    pad = (-n) % 128
    padded = np.concatenate([emb, np.zeros((pad, d), np.float32)])
    ref = np.asarray(cosine_scores_pallas(jnp.asarray(padded),
                                          jnp.asarray(idx), tile_n=128))[:, :n]
    out = topk_kernel.cosine_scores(T(emb), T(idx))
    assert out.shape == (4, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert _launch_counts() == before


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 4, 2, device="meta")
    k = torch.zeros(3, 3, 2, 2, device="meta")
    s = torch.zeros(2, device="meta")
    with pytest.raises(ValueError):
        conv_block_kernel.conv_block(x, [k], [s], [s])
    with pytest.raises(ValueError):
        upsample_conv_kernel.upsample2_conv3x3_bn_act(x, k, s, s)
    with pytest.raises(ValueError):
        topk_kernel.cosine_scores(torch.zeros(4, 3, device="meta"),
                                  torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError):  # mixed devices
        conv_block_kernel.conv_block(torch.zeros(1, 4, 4, 2), [k], [s], [s])


@pytest.mark.parametrize("cf", [1, 3])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_upsample_head_plain_matches_jax(rng, cf, dtype, tol):
    """U with the fused final head (final_kernel, final_bias, sigmoid)
    against the JAX kernel in interpret mode, as tests/test_ops.py runs it:
    f32 within 1e-5, bf16 within 1e-2 of the output's scale (the kernels
    are handed over rounded to bf16, as the fast G hands them); no launch
    of either counter on the CPU."""
    before = (_launch_counts(),
              upsample_conv_kernel.upsample2_conv3x3_head.launches)
    jdt = getattr(jnp, dtype)
    x = rng.normal(size=(2, 6, 4, 5)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 5, 8)) * 0.3).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    sh = (rng.normal(size=8) * 0.1).astype(np.float32)
    fk = (rng.normal(size=(3, 3, 8, cf)) * 0.3).astype(np.float32)
    fb = (rng.normal(size=cf) * 0.1).astype(np.float32)
    xj, kj, fkj = (jnp.asarray(a).astype(jdt) for a in (x, k, fk))
    ref = np.asarray(j_upsample(xj, kj, sc, sh, act="relu", tile_n=1,
                                interpret=True, final_kernel=fkj,
                                final_bias=fb, final_act="sigmoid"
                                ).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    xt, kt, fkt = (T(np.array(a.astype(jnp.float32))).to(tdt)
                   for a in (xj, kj, fkj))
    out = upsample_conv_kernel.upsample2_conv3x3_bn_act(
        xt, kt, T(sc), T(sh), act="relu", final_kernel=fkt,
        final_bias=T(fb), final_act="sigmoid")
    assert out.shape == ref.shape == (2, 12, 8, cf) and out.dtype == tdt
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err
    assert (_launch_counts(),
            upsample_conv_kernel.upsample2_conv3x3_head.launches) == before
