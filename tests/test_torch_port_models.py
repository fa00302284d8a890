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


@pytest.mark.parametrize("dtype", [
    pytest.param("float32", id="dilated"),
    pytest.param("bfloat16", id="dilated_bf16")])
def test_upsample_conv_formulations_match_jax(rng, dtype):
    """UpsampleConv's lhs-dilated formulation against JAX's, and in f32
    against JAX's naive upsample-then-conv. In bf16 both round the operands
    and the output at the same places but sum in another order, so they may
    land one bf16 ulp (2^-7 relative at most) apart."""
    from ganreverser_tpu.ops import upsample_conv as jup
    from ganreverser_tpu_torch.ops import upsample_conv as tup
    x = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    k = rng.normal(size=(3, 3, 4, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    ref = np.asarray(jup.upsample2_conv3x3_dilated(
        x, k, b, dtype=getattr(jnp, dtype))).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(
            ref, np.asarray(jup.upsample2_conv3x3_reference(x, k, b)),
            rtol=1e-4, atol=1e-4)
    args = [torch.from_numpy(a) for a in (x, k, b)]
    out = tup.upsample2_conv3x3_dilated(*args, dtype=getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype)
    rtol, atol = (1e-4, 1e-4) if dtype == "float32" else (8e-3, 1e-5)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=rtol, atol=atol)


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
