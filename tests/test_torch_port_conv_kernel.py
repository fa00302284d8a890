"""Kernel B6 (ops/conv_kernel.py::conv3x3_bn_act): its plain version, which
the wrapper takes on CPU tensors, against the JAX package's Pallas kernel
run in interpret mode, as tests/test_pallas.py runs it. Inputs are numpy
arrays from a seed; the bf16 kernel is rounded to bf16 before both get it
(the Pallas kernel multiplies whatever dtype its weights have).

Tolerances, relative to max(1, max |JAX|): f32 1e-5 (f32 sums in another
order); bf16 2**-7, one bf16 ulp at that scale (the same f32 value rounded
once, which the sum order may move across a rounding boundary)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu.ops.conv_kernel import conv3x3_bn_act as j_conv
from ganreverser_tpu_torch.ops import conv_kernel as ck

from torch_port_fixtures import one_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def _inputs(rng, n, h, w, ci, co, dtype):
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        k = np.array(jnp.asarray(k).astype(jnp.bfloat16).astype(jnp.float32))
    scale = rng.uniform(0.5, 1.5, co).astype(np.float32)
    shift = (0.1 * rng.normal(size=co)).astype(np.float32)
    return x, k, scale, shift


def _jax(x, k, scale, shift, dtype, **kw):
    jd = getattr(jnp, dtype)
    out = j_conv(jnp.asarray(x).astype(jd), jnp.asarray(k).astype(jd),
                 jnp.asarray(scale), jnp.asarray(shift), tile_n=2,
                 interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(x, k, scale, shift, dtype, **kw):
    td = getattr(torch, dtype)
    out = ck.conv3x3_bn_act(torch.from_numpy(x).to(td),
                            torch.from_numpy(k), torch.from_numpy(scale),
                            torch.from_numpy(shift), **kw)
    assert out.dtype == td
    return out.float().numpy()


def _close(out, ref, dtype):
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= TOL[dtype] * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("act", ["relu", "elu", "prelu", "none"])
def test_plain_matches_jax_kernel(rng, act, pool, dtype):
    """(2,8,8,4)->8 and D2's first layer, Ci = 3 -> 8 (the slope 0.25)."""
    for ci in (4, 3):
        x, k, scale, shift = _inputs(rng, 2, 8, 8, ci, 8, dtype)
        kw = dict(act=act, pool=pool, prelu_alpha=0.25)
        ref = _jax(x, k, scale, shift, dtype, **kw)
        assert ref.shape == ((2, 4, 4, 8) if pool else (2, 8, 8, 8))
        _close(_port(x, k, scale, shift, dtype, **kw), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [0.25, -0.3, 0.0])
def test_prelu_slope_as_tensor_or_float(rng, alpha, dtype):
    """The slope given as a one-element tensor (what the kernel reads from
    device memory) or as a float gives the same output, the JAX kernel's
    for that slope, negative and zero slopes included."""
    x, k, scale, shift = _inputs(rng, 2, 8, 8, 4, 8, dtype)
    ref = _jax(x, k, scale, shift, dtype, act="prelu", prelu_alpha=alpha,
               pool=True)
    as_float = _port(x, k, scale, shift, dtype, act="prelu",
                     prelu_alpha=alpha, pool=True)
    as_tensor = _port(x, k, scale, shift, dtype, act="prelu",
                      prelu_alpha=torch.tensor([alpha]), pool=True)
    np.testing.assert_array_equal(as_float, as_tensor)
    _close(as_float, ref, dtype)
    if alpha == 0.0:
        assert as_float.min() >= 0.0


def test_wrapper_contract():
    """An unknown activation and odd H or W with the pool are refused; on
    CPU tensors the plain version runs and the launch counter stays."""
    x = torch.zeros(1, 6, 5, 2)
    k = torch.zeros(3, 3, 2, 4)
    s = torch.ones(4)
    with pytest.raises(ValueError):
        ck.conv3x3_bn_act(x, k, s, s, act="sigmoid")
    with pytest.raises(ValueError):
        ck.conv3x3_bn_act(x, k, s, s, pool=True)
    with pytest.raises(ValueError):
        ck.conv3x3_bn_act_plain(x[:, :, :4], k, s, s, act="gelu")
    before = ck.conv3x3_bn_act.launches
    out = ck.conv3x3_bn_act(x[:, :, :4], k, s, s, act="prelu", pool=True)
    assert out.shape == (1, 3, 2, 4) and ck.conv3x3_bn_act.launches == before
    assert torch.equal(out, torch.ones(1, 3, 2, 4))
