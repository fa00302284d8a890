"""Kernels B7 (conv_stats), B8 (upsample_v2) and B9 (the backend probes):
their plain versions against what the JAX probe scripts hold their Pallas
kernels to, at small shapes on the CPU, and the port's probe entry points
with ``--cpu --smoke``. Tolerances: f32 sums in another order, 1e-5 of
scale; B9 exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu.ops.upsample_conv_kernel import (
    phase_kernels as j_phase_kernels,
    upsample2_conv3x3_bn_act as j_upsample)
from ganreverser_tpu_torch.ops import (conv_stats_kernel, probe_kernels,
                                       upsample_v2_kernel)
from ganreverser_tpu_torch.probes import convbn, kernel_probe, upsample_v2

T = torch.from_numpy


def _counts():
    return (conv_stats_kernel.conv_stats.launches,
            upsample_v2_kernel.upsample_v2.launches,
            probe_kernels.add_one.launches, probe_kernels.times_two.launches,
            probe_kernels.dot_bf16.launches)


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("shape,co", [((4, 8, 8, 16), 32), ((3, 5, 7, 6), 9)])
def test_conv_stats_plain_matches_lax(rng, shape, co):
    """y, sum and sumsq against the lax conv (f32 accumulation) and the
    sums convbn_probe.py derives its mean and variance from."""
    before = _counts()
    x = (rng.normal(size=shape) * 0.5).astype(np.float32)
    k = (rng.normal(size=(3, 3, shape[-1], co)) * 0.05).astype(np.float32)
    y_ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    y, s, q = conv_stats_kernel.conv_stats(T(x), T(k))
    assert y.dtype == s.dtype == q.dtype == torch.float32
    _close(y, y_ref, 1e-5)
    _close(s, jnp.sum(y_ref, axis=(0, 1, 2)), 1e-5)
    _close(q, jnp.sum(jnp.square(y_ref), axis=(0, 1, 2)), 1e-5)
    assert _counts() == before


def test_stacked_phase_kernels_match_jax_restacking(rng):
    """(4, 4Ci, Co): tpu_upsample_v2.py's stacking of the JAX phase
    kernels, phase a*2+b, taps (0,0), (0,1), (1,0), (1,1) top to bottom."""
    k = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    pk = j_phase_kernels(jnp.asarray(k))
    ref = jnp.stack([jnp.concatenate([pk[a, ta, b, tb] for ta in (0, 1)
                                      for tb in (0, 1)], axis=0)
                     for a in (0, 1) for b in (0, 1)])
    out = upsample_v2_kernel.stacked_phase_kernels(T(k))
    assert out.shape == (4, 20, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_upsample_v2_plain_matches_jax_u(rng):
    """B8's plain version against the JAX kernel U with ReLU in interpret
    mode, what tpu_upsample_v2.py compares its variant with."""
    before = _counts()
    x = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 6, 9)) * 0.3).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, 9).astype(np.float32)
    sh = rng.normal(size=9).astype(np.float32)
    ref = j_upsample(x, k, sc, sh, act="relu", tile_n=1, interpret=True)
    out = upsample_v2_kernel.upsample_v2(T(x), T(k), T(sc), T(sh))
    assert out.shape == (2, 8, 10, 9) and out.dtype == torch.float32
    _close(out, ref, 1e-5)
    assert _counts() == before


def test_probe_plain_versions_match_numpy(rng):
    x = rng.normal(size=(8, 128)).astype(np.float32)
    np.testing.assert_array_equal(probe_kernels.add_one(T(x)).numpy(), x + 1)
    x3 = rng.normal(size=(4, 256, 128)).astype(np.float32)
    np.testing.assert_array_equal(probe_kernels.times_two(T(x3)).numpy(),
                                  x3 * 2)
    a = rng.integers(-3, 4, (128, 128)).astype(np.float32)
    b = rng.integers(-3, 4, (128, 48)).astype(np.float32)
    out = probe_kernels.dot_bf16(T(a).to(torch.bfloat16),
                                 T(b).to(torch.bfloat16))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), a @ b)


def test_probe_entry_points_on_cpu(capsys):
    """Each probe with --cpu --smoke: parity asserted, nothing timed on the
    CPU, no kernel launched; kernel_probe prints one OK line per probe and
    exits 0."""
    before = _counts()
    recs = convbn.main(["--cpu", "--smoke"])
    assert [r["ms"] for r in recs] == [None, None]
    assert all(r["device"] == "cpu" for r in recs)
    recs = upsample_v2.main(["--cpu", "--smoke"])
    assert len(recs) == 2 and all(r["max_err"] <= r["tol"] for r in recs)
    assert kernel_probe.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("trivial_add", "gridded", "tensor_core_dot",
                 "upsample_kernel_tiny"):
        assert f"[probe] {name}: OK" in out
    assert _counts() == before


def test_probes_need_the_card_without_cpu_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (convbn.main, upsample_v2.main, kernel_probe.main):
        with pytest.raises(SystemExit):
            main(["--smoke"])


def test_kernel_probe_exits_nonzero_on_a_failing_probe(monkeypatch, capsys):
    monkeypatch.setattr(probe_kernels, "add_one",
                        lambda x: probe_kernels.add_one_plain(x) + 1.0)
    assert kernel_probe.main(["--cpu"]) == 1
    out = capsys.readouterr().out
    assert "[probe] trivial_add: FAIL AssertionError" in out
    assert "[probe] gridded: OK" in out
