"""The ported slice as a whole against the JAX package: fast G -> fast R ->
cosine top-k on the same z and weights; the port's apply_r (all six stages)
on a JAX-written checkpoint; device selection; and the port importing no
JAX."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import io as gio
from ganreverser_tpu import models as M
from ganreverser_tpu.models.fastpath import (make_fast_generator as j_fast_g,
                                             make_fast_inverter as j_fast_r)
from ganreverser_tpu.ops.topk_kernel import cosine_topk_pallas
from ganreverser_tpu_torch.analysis.batched import forward_batched
from ganreverser_tpu_torch.analysis.similarity import (cosine_scores,
                                                       cosine_topk,
                                                       pixel_cosine_topk,
                                                       topk_recall)
from ganreverser_tpu_torch.cli import apply_r, common
from ganreverser_tpu_torch.models import bridge, fastpath
from ganreverser_tpu_torch.ops import (conv_block_kernel, topk_kernel,
                                       upsample_conv_kernel)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variables(model, in_shape, seed, rng, amplify=1.0):
    """JAX variables with non-trivial BN stats; ``amplify`` scales the
    kernels so that random-init images and latents differ enough to rank
    (random-init G and R give near-tied scores otherwise)."""
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


def _assert_same_topk(scores, idx, ref_scores, ref_idx, all_ref_scores):
    """Scores at 1e-5; index sets per needle equal, except for rows whose
    reference score ties the k-th score within 1e-5 (ties may reorder)."""
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5, atol=1e-5)
    for q in range(idx.shape[0]):
        diff = set(idx[q]) ^ set(ref_idx[q])
        kth = ref_scores[q, -1]
        for i in diff:
            assert abs(all_ref_scores[q, i] - kth) <= 1e-5, (q, i)


def test_slice_matches_jax(rng):
    dims, nd, n = (3, 16, 16), 8, 64
    G, R = M.create_G(dims, nd), M.create_R(dims, nd, "normal")
    gv = _variables(G, (nd,), 1, rng, amplify=4.0)
    rv = _variables(R, (16, 16, 3), 2, rng, amplify=4.0)
    z = rng.normal(size=(n, nd)).astype(np.float32)
    needles = np.array([0, 9, 31, 63])

    j_images = j_fast_g(dims, nd, dtype=jnp.float32, tile_n=2)(gv, z)
    j_emb = j_fast_r(dims, nd, "normal", dtype=jnp.float32, tile_n=2)(
        rv, j_images)
    j_sc, j_idx = cosine_topk_pallas(j_emb, jnp.asarray(needles), 10)
    j_all = np.asarray(cosine_scores(torch.from_numpy(np.array(j_emb)),
                                     torch.from_numpy(needles)))

    gen = fastpath.make_fast_generator(dims, nd, torch.float32)
    inv = fastpath.make_fast_inverter(dims, nd, "normal", torch.float32)
    t_images = gen(bridge.to_torch(gv, "cpu"), torch.from_numpy(z))
    t_emb = inv(bridge.to_torch(rv, "cpu"), t_images)
    t_sc, t_idx = cosine_topk(t_emb, torch.from_numpy(needles), 10)

    np.testing.assert_allclose(t_images.numpy(), np.asarray(j_images),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=1e-4,
                               atol=1e-4)
    _assert_same_topk(t_sc.numpy(), t_idx.numpy(), np.asarray(j_sc),
                      np.asarray(j_idx), j_all)
    # the pixel search of the same images
    p_sc, p_idx = pixel_cosine_topk(t_images, torch.from_numpy(needles), 10)
    jp_sc, jp_idx = cosine_topk_pallas(
        np.asarray(j_images).reshape(n, -1), jnp.asarray(needles), 10)
    jp_all = np.asarray(cosine_scores(
        torch.from_numpy(np.array(j_images).reshape(n, -1)),
        torch.from_numpy(needles)))
    _assert_same_topk(p_sc.numpy(), p_idx.numpy(), np.asarray(jp_sc),
                      np.asarray(jp_idx), jp_all)
    assert topk_recall(np.asarray(j_idx), t_idx.numpy()) >= 0.9


@pytest.mark.parametrize("noise_method", ["normal", "uniform"])
def test_fast_forwards_match_port_modules(rng, noise_method):
    """fastpath on the CPU (the kernels' plain versions) == the port's own
    modules in evaluation, f32."""
    from ganreverser_tpu_torch.models import zoo
    dims, nd = (1, 8, 8), 6
    gv = _variables(M.create_G(dims, nd), (nd,), 3, rng)
    rv = _variables(M.create_R(dims, nd, noise_method), (8, 8, 1), 4, rng)
    z = torch.from_numpy(rng.normal(size=(5, nd)).astype(np.float32))
    with torch.no_grad():
        images = bridge.load_jax_variables(zoo.create_G3(dims, nd), gv)(z)
        emb = bridge.load_jax_variables(
            zoo.create_R(dims, nd, noise_method), rv)(images)
    f_images = fastpath.make_fast_generator(dims, nd, torch.float32)(
        bridge.to_torch(gv, "cpu"), z)
    f_emb = fastpath.make_fast_inverter(dims, nd, noise_method,
                                        torch.float32)(
        bridge.to_torch(rv, "cpu"), images)
    np.testing.assert_allclose(f_images.numpy(), images.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f_emb.numpy(), emb.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_forward_batched_pads_with_last_row():
    seen = []

    def fn(b):
        seen.append(b.shape[0])
        return b * 2

    x = torch.arange(10.0).reshape(10, 1)
    out = forward_batched(fn, x, 4)
    assert seen == [4, 4, 4]
    np.testing.assert_array_equal(out.numpy(), x.numpy() * 2)
    assert forward_batched(fn, x, 16).shape == (10, 1)


def _write_jax_checkpoints(save, rng, dims, nd, colorspace):
    c, h, w = dims
    G, R = M.create_G(dims, nd), M.create_R(dims, nd, "normal")
    gv = _variables(G, (nd,), 5, rng, amplify=4.0)
    rv = _variables(R, (h, w, c), 6, rng, amplify=4.0)
    cfg = {"noiseDim": nd, "noiseMethod": "normal", "colorSpace": colorspace,
           "height": h, "width": w}
    gio.save_checkpoint(gio.adversarial_name(save), {"G": gv, "D": {}},
                        config=cfg)
    gio.save_checkpoint(gio.r_name(save, c, h, w, nd, "normal", False),
                        {"R": rv}, config=cfg)


def test_apply_r_on_cpu_writes_artifacts(tmp_path, rng, capsys):
    save, out = str(tmp_path / "logs"), str(tmp_path / "out")
    _write_jax_checkpoints(save, rng, (1, 8, 8), 6, "y")
    result = apply_r.main(["--G", os.path.join(save, "adversarial"),
                           "--save", save, "--writeto", out, "--N", "200",
                           "--needles", "2", "--batchSize", "64"])
    printed = capsys.readouterr().out
    for i in (1, 2):
        for tag in ("attributes", "pixelwise"):
            assert os.path.isfile(os.path.join(out,
                                               f"similar_{tag}_{i:02d}.jpg"))
    for stage in "①②③④⑤⑥":
        assert f"stage {stage}" in printed
    assert "not ported yet" not in printed
    for name in ("variations.jpg", "fixed_pairs.jpg", "anomalies.jpg",
                 "apply_r_stats.jsonl"):
        assert os.path.isfile(os.path.join(out, name))
    assert result["attributes"].shape == (200, 6)
    assert torch.isfinite(result["attributes"]).all()
    assert result["images"].shape == (200, 8, 8, 1)
    idx = result["attr_topk"][1].numpy()
    assert idx.shape == (2, 100) and idx[0, 0] == 99 and idx[1, 0] == 199
    assert (conv_block_kernel.conv_block.launches,
            upsample_conv_kernel.upsample2_conv3x3_bn_act.launches,
            topk_kernel.cosine_scores.launches) == (0, 0, 0)


@pytest.mark.parametrize("flag", [["--int8"], ["--approx"],
                                  ["--mesh_data", "2"], ["--mesh_model", "2"]])
def test_apply_r_refuses_unported_modes(tmp_path, flag):
    with pytest.raises(SystemExit) as e:
        apply_r.main(["--G", str(tmp_path / "none"), *flag])
    assert "not ported yet" in str(e.value)


def test_apply_r_has_no_pallas_flag(tmp_path, capsys):
    """The JAX CLI's --pallas picks among TPU paths; the port has one path
    per device, so the flag is unknown rather than silently ignored."""
    with pytest.raises(SystemExit) as e:
        apply_r.main(["--G", str(tmp_path / "none"), "--pallas"])
    assert e.value.code == 2
    assert "--pallas" in capsys.readouterr().err


def test_resolve_device(monkeypatch):
    monkeypatch.setenv("GANREVERSER_PLATFORM", "cpu")
    assert common.resolve_device() == torch.device("cpu")
    monkeypatch.setenv("GANREVERSER_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        common.resolve_device()
    monkeypatch.delenv("GANREVERSER_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        common.resolve_device()


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ganreverser_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import ganreverser_tpu_torch.cli.apply_r\n"
        "import ganreverser_tpu_torch.cli.train\n"
        "import ganreverser_tpu_torch.cli.sample\n"
        "import ganreverser_tpu_torch.cli.pretrain_g\n"
        "import ganreverser_tpu_torch.cli.pretrain_prev\n"
        "import ganreverser_tpu_torch.probes.convbn\n"
        "import ganreverser_tpu_torch.probes.upsample_v2\n"
        "import ganreverser_tpu_torch.probes.kernel_probe\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ganreverser_tpu' or m.startswith('ganreverser_tpu.')"
        " or m == 'PIL']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
