"""The port's eval-mode G3 and R modules against the JAX models: the same
weights (through the bridge) and the same numpy inputs give the same
outputs in f32 (rtol/atol 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import models as M
from ganreverser_tpu_torch.models import bridge, modules, zoo

from torch_port_fixtures import one_thread  # noqa: F401

DIMS, ND = (3, 16, 16), 8


def _random_state(variables, rng):
    """Non-trivial BN running stats, so scale/shift mix-ups show."""
    state = jax.tree_util.tree_map(
        lambda leaf: rng.uniform(0.2, 1.5, leaf.shape).astype(np.float32),
        variables["state"])
    return {"params": variables["params"], "state": state}


def _port(module, variables):
    return bridge.load_jax_variables(module, variables)


@pytest.mark.parametrize("fuse", [True, False])
def test_G3_matches_jax(rng, fuse):
    """The port's G3 against the JAX G fused and unfused (one pytree)."""
    G = M.create_G(DIMS, ND, fuse=fuse)
    variables = _random_state(G.init(jax.random.PRNGKey(1), (ND,))[0], rng)
    z = rng.normal(size=(4, ND)).astype(np.float32)
    ref = np.asarray(G.apply(variables, jnp.asarray(z), train=False)[0])
    tg = _port(zoo.create_G3(DIMS, ND), variables)
    with torch.no_grad():
        out = tg(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("noise_method", ["normal", "uniform"])
def test_R_matches_jax(rng, noise_method):
    R = M.create_R(DIMS, ND, noise_method)
    variables = _random_state(R.init(jax.random.PRNGKey(2), (16, 16, 3))[0],
                              rng)
    x = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(R.apply(variables, jnp.asarray(x), train=False)[0])
    tr = _port(zoo.create_R(DIMS, ND, noise_method), variables)
    with torch.no_grad():
        out = tr(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (4, ND)
    if noise_method == "uniform":
        assert np.abs(out).max() <= 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


# (N, H, W, Ci, Co) of the upsample cases: the first, a 1x1 input, batch 1
# non-square and odd, and 16 -> 8 channels
_UPSAMPLE_SHAPES = {"": (2, 5, 6, 4, 7), "-1x1": (2, 1, 1, 4, 7),
                    "-b1_odd": (1, 3, 7, 5, 6), "-c16": (2, 4, 4, 16, 8)}
_UPSAMPLE_CASES = [
    pytest.param(dtype, shape, id=name + suffix)
    for suffix, shape in _UPSAMPLE_SHAPES.items()
    for dtype, name in (("float32", "dilated"), ("bfloat16", "dilated_bf16"))]


def _upsample_inputs(rng, shape):
    n, h, w, ci, co = shape
    return (rng.normal(size=(n, h, w, ci)).astype(np.float32),
            rng.normal(size=(3, 3, ci, co)).astype(np.float32),
            rng.normal(size=(co,)).astype(np.float32))


@pytest.mark.parametrize("dtype,shape", _UPSAMPLE_CASES)
def test_upsample_conv_formulations_match_jax(rng, dtype, shape):
    """UpsampleConv's transposed conv against JAX's lhs-dilated conv, and in
    f32 against JAX's naive upsample-then-conv. In bf16 both round the
    operands and the output at the same places but sum in another order, so
    they may land one bf16 ulp (2^-7 relative at most) apart."""
    from ganreverser_tpu.ops import upsample_conv as jup
    from ganreverser_tpu_torch.ops import upsample_conv as tup
    x, k, b = _upsample_inputs(rng, shape)
    ref = np.asarray(jup.upsample2_conv3x3_dilated(
        x, k, b, dtype=getattr(jnp, dtype))).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(
            ref, np.asarray(jup.upsample2_conv3x3_reference(x, k, b)),
            rtol=1e-4, atol=1e-4)
    args = [torch.from_numpy(a) for a in (x, k, b)]
    out = tup.upsample2_conv3x3_dilated(*args, dtype=getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
    rtol, atol = (1e-4, 1e-4) if dtype == "float32" else (8e-3, 1e-5)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,shape", _UPSAMPLE_CASES)
def test_upsample_conv_gradients_match_jax(rng, dtype, shape):
    """The gradients of UpsampleConv's function for x, the kernel and the
    bias against ``jax.vjp`` of JAX's lhs-dilated conv, for one cotangent
    in the output's dtype. In bf16 both round the x and tap gradients to
    bf16 at the same places (the port in its casts' backward, JAX in its
    low-precision conv's), so they stay within one ulp; the kernel's and the
    bias's sums are f32 in both."""
    from ganreverser_tpu.ops import upsample_conv as jup
    from ganreverser_tpu_torch.ops import upsample_conv as tup
    x, k, b = _upsample_inputs(rng, shape)
    n, h, w, _, co = shape
    ct = jnp.asarray(rng.normal(size=(n, 2 * h, 2 * w, co)),
                     getattr(jnp, dtype))
    _, vjp = jax.vjp(lambda *a: jup.upsample2_conv3x3_dilated(
        *a, dtype=getattr(jnp, dtype)), x, k, b)
    refs = [np.asarray(g, np.float32) for g in vjp(ct)]
    args = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    out = tup.upsample2_conv3x3_dilated(*args, dtype=getattr(torch, dtype))
    out.backward(torch.from_numpy(np.array(ct, np.float32)).to(out.dtype))
    rtol, atol = (1e-4, 1e-6) if dtype == "float32" else (8e-3, 1e-5)
    for a, ref in zip(args, refs):
        assert a.grad.dtype == torch.float32
        np.testing.assert_allclose(a.grad.numpy(), ref, rtol=rtol,
                                   atol=atol * np.abs(ref).max())


def test_modules_are_eval_only():
    """The models come back in evaluation, where BatchNorm uses its running
    statistics and the dropouts are the identity; ``.train()`` switches
    both: BatchNorm normalises with the batch statistics and moves its
    buffers (momentum 0.1, unbiased variance), the dropouts draw from their
    generator."""
    x2 = torch.randn(6, 4, generator=torch.Generator().manual_seed(0)) * 3 + 1
    bn = modules.BatchNorm(4).train()
    y = bn(x2)
    np.testing.assert_allclose(y.mean(0).detach().numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(y.var(0, unbiased=False).detach().numpy(),
                               1.0, rtol=1e-4)
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * x2.mean(0).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(),
                               0.9 + 0.1 * x2.var(0).numpy(), rtol=1e-5)
    mean = bn.mean.clone()
    with torch.no_grad():
        bn.eval()(x2)
    assert torch.equal(bn.mean, mean)
    r = modules.init_parameters(zoo.create_R(DIMS, ND, "normal"),
                                torch.Generator().manual_seed(0))
    assert not r.training and isinstance(r.l3, modules.Dropout)
    x = torch.rand(2, 16, 16, 3)
    with torch.no_grad():
        np.testing.assert_array_equal(r.l3(x).numpy(), x.numpy())
        before = r(x)
    with pytest.raises(ValueError):  # no generator set
        r.train()(x)
    modules.set_dropout_generator(r, torch.Generator().manual_seed(1))
    with torch.no_grad():
        after = r(x)
    assert r.training and not torch.equal(before, after)
    assert not torch.equal(r.l1.mean, torch.zeros(64))


def test_init_parameters_is_seeded():
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return bridge.export_variables(
            modules.init_parameters(zoo.create_R(DIMS, ND, "normal"), g))

    a, b, c = draw(0), draw(0), draw(1)
    ka, kb, kc = (v["params"]["l0"]["kernel"] for v in (a, b, c))
    np.testing.assert_array_equal(ka, kb)
    assert not np.array_equal(ka, kc)
    bound = np.sqrt(1.0 / (3.0 * 27))
    assert 0 < np.abs(ka).max() <= bound
    np.testing.assert_array_equal(a["params"]["l0"]["bias"], 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pinned_precision_sets_and_restores_flags(dtype):
    """f32 pins IEEE convolutions and matmuls, bf16 lets cuDNN use TF32 and
    leaves the matmul flag alone; the caller's flags come back afterwards,
    also after an error."""
    from ganreverser_tpu_torch.core.precision import pinned_precision
    f32 = dtype == torch.float32
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = f32
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError):
            with pinned_precision(dtype):
                assert torch.backends.cudnn.allow_tf32 == (not f32)
                assert torch.backends.cuda.matmul.allow_tf32 == (not f32)
                raise RuntimeError("inside")
        assert torch.backends.cudnn.allow_tf32 == f32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
