"""Kernel B5's plain version (ganreverser_tpu_torch/ops/dropout_kernel.py)
against the JAX kernel ``fused_dropout``, run in interpret mode on the CPU
as tests/test_dropout_kernel.py runs it: the same numpy input and int32 seed
give bitwise-equal outputs and bitwise-equal gradients (tolerance 0), since
both compute the same integer hash and the same single f32 multiply. The
CUDA kernel is held to this plain version on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu.ops import dropout_kernel as jdk
from ganreverser_tpu_torch.ops import dropout_kernel as dk

from torch_port_fixtures import one_thread  # noqa: F401

SHAPES = [(16, 64, 16), (24, 1024), (8, 16, 16, 64)]
DTYPES = ["float32", "bfloat16"]
RATES = [0.5, 0.25]
SEEDS = [42, -7]
CASES = [(s, d, r, k) for s in SHAPES for d in DTYPES for r in RATES
         for k in SEEDS]


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(abs(seed) + len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return x, g, jx, tx


def _seed(seed):
    return torch.tensor([seed], dtype=torch.int32)


def _numpy_bits(n, seed):
    """murmur3 fmix32 of (flat index ^ seed * 0x9E3779B9) in uint32, as
    tests/test_dropout_kernel.py computes the TPU kernel's stream."""
    idx = np.arange(n, dtype=np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = idx ^ (np.uint32(seed & 0xFFFFFFFF) * np.uint32(0x9E3779B9))
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


@pytest.mark.parametrize("shape,dtype,rate,seed", CASES)
def test_plain_forward_bitwise_equals_jax(shape, dtype, rate, seed):
    _, _, jx, tx = _inputs(shape, dtype, seed)
    ref = np.asarray(jdk.fused_dropout(jx, jnp.int32(seed), rate)
                     .astype(jnp.float32))
    out = dk.fused_dropout(tx, _seed(seed), rate)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    np.testing.assert_array_equal(out.float().numpy(), ref)
    kept = ref != 0
    assert abs(kept.mean() - (1 - rate)) < 5 * np.sqrt(
        rate * (1 - rate) / ref.size)


@pytest.mark.parametrize("shape,dtype,rate,seed", CASES)
def test_plain_gradient_bitwise_equals_jax_grad(shape, dtype, rate, seed):
    _, g, jx, tx = _inputs(shape, dtype, seed)
    jg = jnp.asarray(g)
    ref = jax.grad(lambda a: jnp.sum(jdk.fused_dropout(a, jnp.int32(seed), rate)
                                     .astype(jnp.float32) * jg))(jx)
    tx.requires_grad_(True)
    out = dk.fused_dropout(tx, _seed(seed), rate)
    (grad,) = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(),
                                  tx)
    assert grad.dtype == tx.dtype
    np.testing.assert_array_equal(grad.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 42, -7, 2 ** 31 - 1, -2 ** 31])
def test_hash_bits_match_numpy_fmix32(seed):
    n = 3 * 1024 + 5  # not a multiple of the TPU kernel's 8192 either
    bits = dk.hash_bits(n, _seed(seed), "cpu").numpy()
    np.testing.assert_array_equal(bits, _numpy_bits(n, seed).astype(np.int64))
    assert bits.min() >= 0 and bits.max() <= 0xFFFFFFFF


@pytest.mark.parametrize("rate", [0.5, 0.25, 0.1, 0.0, 0.9])
def test_threshold_and_multiplier(rate):
    keep = 1.0 - rate
    assert dk.keep_threshold(rate) == min(int(round(keep * 2 ** 32)),
                                          2 ** 32 - 1)
    assert dk.inv_keep_f32(rate) == float(np.float32(1.0 / keep))
    # the launch's cached scalars are the same numbers, per dtype
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        assert dk.dropout_plan(rate, dtype) == (
            code, dk.keep_threshold(rate), dk.inv_keep_f32(rate))


def test_any_size_and_layout():
    """Sizes the TPU wrapper's gate refuses are taken; a strided view is
    dropped in its logical order."""
    x = torch.randn(7, 13, 3)
    y = dk.fused_dropout(x, _seed(5), 0.5)
    keep = _numpy_bits(x.numel(), 5) < dk.keep_threshold(0.5)
    np.testing.assert_array_equal(y.numpy().reshape(-1),
                                  np.where(keep, x.numpy().reshape(-1) * 2, 0))
    xt = torch.randn(13, 7, 3).transpose(0, 1)
    np.testing.assert_array_equal(
        dk.fused_dropout(xt, _seed(5), 0.5).numpy(),
        dk.fused_dropout(xt.contiguous(), _seed(5), 0.5).numpy())


def test_wrapper_refuses_and_counts_no_cpu_launch():
    x = torch.ones(4, 8)
    before = dk.fused_dropout.launches
    dk.fused_dropout(x, _seed(1), 0.5)
    assert dk.fused_dropout.launches == before
    with pytest.raises(ValueError):
        dk.fused_dropout(x, _seed(1), 1.0)
    with pytest.raises(ValueError):
        dk.fused_dropout(x, torch.tensor([1]), 0.5)  # int64 seed
    with pytest.raises(ValueError):
        dk.fused_dropout(x.to("meta"), _seed(1).to("meta"), 0.5)
    s = dk.draw_seed(torch.Generator().manual_seed(3), "cpu")
    assert s.dtype == torch.int32 and s.shape == (1,)
    seeds = dk.draw_seed(torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(s, seeds)
