"""ops/pack_conv.py (the lane-packed small-Co conv3x3) and the fast G with
``pack_out`` against the JAX package on the CPU, f32, within 1e-5 of
max(1, max |JAX|). Inputs and weights are numpy arrays from a seed, handed
to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import models as M
from ganreverser_tpu.models.fastpath import make_fast_generator_xla
from ganreverser_tpu.ops.pack_conv import conv3x3_packed as j_packed
from ganreverser_tpu.ops.pack_conv import pack_kernel as j_pack_kernel
from ganreverser_tpu_torch.models import bridge, fastpath
from ganreverser_tpu_torch.ops import pack_conv
from ganreverser_tpu_torch.ops.upsample_conv import conv_nhwc

T = torch.from_numpy


def _close(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


# tests/test_ops.py's shapes: (H, W, Ci, Co, pack, act)
SHAPES = [(8, 8, 8, 3, (2, 4), "sigmoid"),
          (16, 16, 16, 3, (4, 8), "sigmoid"),
          (16, 8, 8, 1, (8, 8), None),
          (8, 16, 5, 4, (2, 2), "relu"),
          (8, 8, 16, 8, (1, 2), "elu")]


@pytest.mark.parametrize("h,w,ci,co,pack,act", SHAPES)
def test_conv3x3_packed_matches_jax(rng, h, w, ci, co, pack, act):
    """The block kernel bitwise JAX's, and the packed conv + bias + act
    within 1e-5 of JAX's, and of the port's own unpacked conv."""
    x = rng.normal(size=(2, h, w, ci)).astype(np.float32)
    k = (0.2 * rng.normal(size=(3, 3, ci, co))).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    np.testing.assert_array_equal(pack_conv.pack_kernel(T(k), pack).numpy(),
                                  np.asarray(j_pack_kernel(jnp.asarray(k),
                                                           pack)))
    ref = j_packed(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), pack, act)
    out = pack_conv.conv3x3_packed(T(x), T(k), T(b), pack, act)
    assert out.dtype == torch.float32
    _close(out, ref)
    unpacked = conv_nhwc(T(x), T(k), 1, torch.float32)
    unpacked = unpacked + T(b)
    unpacked = {"sigmoid": torch.sigmoid, "relu": torch.relu,
                "elu": torch.nn.functional.elu,
                None: lambda y: y}[act](unpacked)
    _close(out, unpacked)


def test_conv3x3_packed_refuses_a_geometry_off_the_pack():
    x = torch.zeros(1, 6, 6, 4)
    with pytest.raises(ValueError, match="not divisible"):
        pack_conv.conv3x3_packed(x, torch.zeros(3, 3, 4, 3), torch.zeros(3),
                                 (4, 4))
    with pytest.raises(ValueError, match="gelu"):
        pack_conv.conv3x3_packed(x, torch.zeros(3, 3, 4, 3), torch.zeros(3),
                                 (2, 2), "gelu")


def test_conv3x3_packed_bf16_rounds_as_jax(rng):
    """In bf16: operands rounded, f32 sums, one rounding of the output,
    as JAX's ``dtype=bfloat16``; within one bf16 ulp of its output."""
    x = rng.uniform(size=(2, 16, 16, 32)).astype(np.float32)
    k = (0.1 * rng.normal(size=(3, 3, 32, 3))).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    ref = j_packed(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), (4, 8),
                   "sigmoid", jnp.bfloat16)
    out = pack_conv.conv3x3_packed(T(x), T(k), T(b), (4, 8), "sigmoid",
                                   torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(ref, np.float32), 2 ** -8)


def _g_variables(dims, nd, seed):
    G = M.create_G(dims, nd)
    v, _ = G.init(jax.random.PRNGKey(seed), (nd,))
    r = np.random.default_rng(seed)
    state = {layer: {"mean": (0.1 * r.normal(size=s["mean"].shape)
                              ).astype(np.float32),
                     "var": r.uniform(0.5, 1.5, s["var"].shape
                                      ).astype(np.float32)}
             for layer, s in v["state"].items()}
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
            "state": state}


def test_fast_generator_pack_out_matches_jax():
    """make_fast_generator(pack_out=(4, 8)) against JAX's
    make_fast_generator_xla(pack_out=(4, 8)) at (3, 32, 32), noise 8, f32
    within 1e-5, and against the port's unpacked fast G; pack_out with
    fused_head is refused."""
    dims, nd = (3, 32, 32), 8
    gv = _g_variables(dims, nd, 0)
    z = np.random.default_rng(1).normal(size=(4, nd)).astype(np.float32)
    ref = make_fast_generator_xla(dims, nd, dtype=jnp.float32,
                                  pack_out=(4, 8))(gv, jnp.asarray(z))
    tv = bridge.to_torch(gv, "cpu")
    out = fastpath.make_fast_generator(dims, nd, torch.float32,
                                       pack_out=(4, 8))(tv, T(z))
    assert out.shape == (4, 32, 32, 3)
    _close(out, ref)
    _close(out, fastpath.make_fast_generator(dims, nd, torch.float32)(
        tv, T(z)))
    with pytest.raises(ValueError, match="choose one"):
        fastpath.make_fast_generator(dims, nd, torch.float32,
                                     fused_head=True, pack_out=(4, 8))
