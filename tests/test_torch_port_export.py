"""Serving artifacts (ganreverser_tpu_torch/io/serving.py and
cli/export.py) against the JAX package on the CPU: the port's ``export``
writes each program from checkpoints that the JAX package's
save_checkpoint wrote, the artifact is loaded back, and its outputs are
held to JAX's live program of the same ``--what`` on the same numpy
inputs (JAX bakes the module R for ``invert`` and its XLA fast G for
``generate``; the port bakes its fast R and fast G, whose plain versions
run on the CPU).

Tolerances: f32 embeddings and images within 1e-4 of the scale (f32 sums
in another order, as tests/test_torch_port_e2e.py holds the fast
forwards); the e2e top-k values within 1e-4 and the index sets equal on
every row whose JAX k-th score leads the (k+1)-th by more than 1e-4 (at
least one such row). Under --int8 within two int8 levels of the scale (2
max|out| / 127: a value near a rounding boundary may quantise one level
apart, tests/test_torch_port_quant.py), the e2e embeddings and top-k values
within 8 levels (five chunks of per-tensor scales). Those differences
move cosine scores by more than the gaps between this small model's
neighbours, so under --int8 the index sets are held, on rows separated by
more than 1e-4, to JAX's search (analysis.topk_all) run on the
artifact's own embeddings."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import analysis as JA
from ganreverser_tpu import io as gio
from ganreverser_tpu import models as M
from ganreverser_tpu.cli import export as j_export
from ganreverser_tpu.models import fastpath as JF
from ganreverser_tpu_torch.cli import export
from ganreverser_tpu_torch.io import serving
from ganreverser_tpu_torch.ops import quant

from torch_port_fixtures import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS, ND, BATCH, N, K = (1, 8, 8), 6, 8, 40, 4


def _variables(model, in_shape, seed, rng, amplify=4.0):
    """JAX variables with non-trivial BatchNorm statistics and the kernels
    scaled by ``amplify`` (random-init G and R give near-tied scores
    otherwise), as numpy."""
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


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """JAX-written G and R checkpoints at DIMS, their variables, G and R."""
    rng = np.random.default_rng(12)
    save = str(tmp_path_factory.mktemp("export") / "logs")
    c, h, w = DIMS
    G, R = M.create_G(DIMS, ND), M.create_R(DIMS, ND, "normal")
    gv = _variables(G, (ND,), 1, rng)
    rv = _variables(R, (h, w, c), 2, rng)
    cfg = {"noiseDim": ND, "noiseMethod": "normal", "colorSpace": "y",
           "height": h, "width": w}
    gio.save_checkpoint(gio.adversarial_name(save), {"G": gv, "D": {}},
                        config=cfg)
    gio.save_checkpoint(gio.r_name(save, c, h, w, ND, "normal", False),
                        {"R": rv}, config=cfg)
    return {"save": save, "G": G, "R": R, "gv": gv, "rv": rv,
            "g": gio.adversarial_name(save)}


def _export(ckpts, out, *args):
    return export.main(["--G", ckpts["g"], "--save", ckpts["save"], "--out",
                        out, "--batch", str(BATCH), "--N", str(N), "--k",
                        str(K), "--platforms", "cpu", "--check", *args])


def _close(port, ref, rel):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(port, np.float32) - ref).max()
    assert err <= rel * max(1.0, np.abs(ref).max()), err


def _levels(port, ref, n):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(port, np.float32) - ref).max()
    assert err <= n * np.abs(ref).max() / 127.0, err


def _jax_e2e(ckpts, int8):
    G, R = ckpts["G"], ckpts["R"]
    if int8:
        g8 = JF.make_fast_generator_xla_int8(DIMS, ND, jnp.float32)
        r8 = JF.make_fast_inverter_int8(DIMS, ND, "normal", jnp.float32)
        return JA.make_e2e_program(G, R, batch_size=BATCH, k=K,
                                   g_apply=lambda g, zc: g8(g, zc),
                                   r_apply=lambda r, im: r8(r, im))
    fg = JF.make_fast_generator_xla(DIMS, ND, jnp.float32)
    return JA.make_e2e_program(G, R, batch_size=BATCH, k=K,
                               g_apply=lambda g, zc: fg(g, zc))


def _same_topk_where_separated(i, ji, jscores, margin):
    """The port's index sets equal JAX's on every row whose k-th JAX score
    leads the (k+1)-th by more than ``margin``; returns how many rows."""
    top = -np.sort(-jscores, axis=1)
    sep = top[:, K - 1] - top[:, K] > margin
    assert sep.any()
    for row in np.nonzero(sep)[0]:
        assert set(i[row]) == set(np.asarray(ji)[row]), row
    return int(sep.sum())


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("what", ["invert", "generate", "e2e"])
def test_export_matches_jax_live_program(ckpts, tmp_path, what, int8):
    out = str(tmp_path / "serve")
    result = _export(ckpts, out, "--what", what,
                     *(["--int8"] if int8 else []))
    assert result["check_err"] <= (0.05 if int8 else 1e-3) * max(
        1.0, result["check_scale"])
    call, meta = serving.load_serving_program(out, "cpu")
    assert (meta["what"], meta["int8"], meta["batch"]) == (what, int8, BATCH)
    rng = np.random.default_rng(3)
    gv, rv = ckpts["gv"], ckpts["rv"]
    if what == "invert":
        x = rng.uniform(size=(BATCH, 8, 8, 1)).astype(np.float32)
        got = call(torch.from_numpy(x))
        want = (JF.make_fast_inverter_int8(DIMS, ND, "normal", jnp.float32)(
            rv, x) if int8 else ckpts["R"].apply(rv, x, train=False)[0])
        assert got.shape == (BATCH, ND)
    elif what == "generate":
        z = rng.normal(size=(BATCH, ND)).astype(np.float32)
        got = call(torch.from_numpy(z))
        want = (JF.make_fast_generator_xla_int8 if int8
                else JF.make_fast_generator_xla)(DIMS, ND, jnp.float32)(gv, z)
        assert got.shape == (BATCH, 8, 8, 1)
    else:
        z = rng.normal(size=(N, ND)).astype(np.float32)
        emb, v, i = call(torch.from_numpy(z))
        jemb, jv, ji = _jax_e2e(ckpts, int8)(gv, rv, z)
        jemb = np.asarray(jemb)
        jn = jemb / np.linalg.norm(jemb, axis=1, keepdims=True)
        if int8:
            _levels(emb, jemb, 8.0)
            _levels(v, jv, 8.0)
            ji = JA.topk_all(jnp.asarray(emb.numpy()), K)[1]
            tn = emb.numpy() / np.linalg.norm(emb.numpy(), axis=1,
                                              keepdims=True)
            jn = tn
        else:
            _close(emb, jemb, 1e-4)
            _close(v, jv, 1e-4)
        assert emb.shape == (N, ND) and i.shape == (N, K)
        _same_topk_where_separated(i.numpy(), ji, jn @ jn.T, 1e-4)
        return
    if int8:
        _levels(got, want, 2.0)
    else:
        _close(got, want, 1e-4)


def test_manifest_keys_are_jax_keys(ckpts, tmp_path):
    """The manifest holds the JAX package's keys, with ``torch_version`` in
    place of ``jax_version`` and the port's format and platforms."""
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "port")
    j_export.main(["--G", ckpts["g"], "--save", ckpts["save"], "--out",
                   j_out, "--what", "invert", "--batch", str(BATCH),
                   "--platforms", "cpu"])
    export.main(["--G", ckpts["g"], "--save", ckpts["save"], "--out", t_out,
                 "--what", "invert", "--batch", str(BATCH)])
    jm = json.load(open(os.path.join(j_out, "manifest.json")))
    tm = json.load(open(os.path.join(t_out, "manifest.json")))
    assert set(tm) == set(jm) - {"jax_version"} | {"torch_version"}
    assert tm["format"] == "torch.export/pt2" and jm["format"] != tm["format"]
    assert tm["torch_version"] == torch.__version__
    assert tm["platforms"] == ["cuda", "cpu"] and jm["platforms"] == ["cpu"]
    assert {k: tm[k] for k in jm if k not in (
        "format", "jax_version", "platforms")} == {
        k: jm[k] for k in jm if k not in ("format", "jax_version",
                                          "platforms")}
    assert os.path.isfile(os.path.join(t_out, serving.PROGRAM))


def test_artifact_runs_in_a_fresh_process_without_model_code(ckpts,
                                                             tmp_path):
    """A fresh process that imports only io.serving loads and runs the e2e
    artifact, with no module of models/, cli/ or analysis/e2e.py imported,
    and gives the exporting process's result."""
    out = str(tmp_path / "serve")
    _export(ckpts, out, "--what", "e2e")
    z = np.random.default_rng(4).normal(size=(N, ND)).astype(np.float32)
    np.save(str(tmp_path / "z.npy"), z)
    call, _ = serving.load_serving_program(out, "cpu")
    want = call(torch.from_numpy(z))
    code = (
        "import sys, numpy as np, torch\n"
        "from ganreverser_tpu_torch.io.serving import load_serving_program\n"
        f"call, meta = load_serving_program({out!r}, 'cpu')\n"
        f"emb, v, i = call(np.load({str(tmp_path / 'z.npy')!r}))\n"
        f"np.save({str(tmp_path / 'got.npy')!r}, emb.numpy())\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'ganreverser_tpu_torch.models', 'ganreverser_tpu_torch.cli', "
        "'ganreverser_tpu_torch.analysis.e2e', 'jax', 'ganreverser_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('SERVED', meta['what'], tuple(emb.shape))\n")
    env = dict(os.environ, GANREVERSER_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=240,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert f"SERVED e2e {(N, ND)}" in proc.stdout
    np.testing.assert_array_equal(np.load(str(tmp_path / "got.npy")),
                                  want[0].numpy())


def test_export_refuses_tpu(ckpts, tmp_path):
    with pytest.raises(SystemExit) as e:
        export.main(["--G", ckpts["g"], "--save", ckpts["save"], "--out",
                     str(tmp_path / "x"), "--platforms", "tpu,cpu"])
    assert "tpu" in str(e.value) and "JAX" in str(e.value)
    assert not os.path.exists(tmp_path / "x")


def test_loader_refuses_an_unlisted_device(ckpts, tmp_path):
    """An artifact for the card alone does not load on the CPU; the error
    names the artifact's platforms."""
    out = str(tmp_path / "serve")
    export.main(["--G", ckpts["g"], "--save", ckpts["save"], "--out", out,
                 "--what", "generate", "--batch", "2", "--platforms",
                 "cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        serving.load_serving_program(out, "cpu")


def test_serving_roundtrip_of_a_closure(tmp_path):
    """save/load of any function closing over tensors: the tensors are
    baked in, and the loaded program gives the live result."""
    w = torch.randn(5, 3)
    b = torch.randn(3)

    def fn(x):
        return torch.relu(x @ w + b), (x @ w).argmax(1)

    x = torch.randn(4, 5)
    out = str(tmp_path / "serve")
    serving.save_serving_program(out, fn, (x,), {"what": "toy"},
                                 platforms=("cpu",))
    call, meta = serving.load_serving_program(out, "cpu")
    assert meta["what"] == "toy" and meta["platforms"] == ["cpu"]
    got, want = call(x), fn(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        serving.save_serving_program(out, fn, (x,), {}, platforms=("tpu",))


@pytest.mark.parametrize("layout", [None, "words-of-four",
                                    "taps-co-ci-int8"])
def test_loader_refuses_an_int8_artifact_of_another_operand_layout(
        tmp_path, layout):
    """An int8 artifact records the int8 kernels' operand layout and loads;
    one without that record (exported before Q1 and Q2 read K-major int8
    weights: its baked operands are words of four channels), one of the
    layout before Q3 read K-major int8 weights ("taps-co-ci-int8": Q3's
    operands still words) or of another layout is refused, with a message
    saying to export it again."""
    w = torch.randn(5, 3)

    def fn(x):
        return x @ w

    out = str(tmp_path / "serve")
    serving.save_serving_program(out, fn, (torch.randn(4, 5),),
                                 {"what": "toy", "int8": True},
                                 platforms=("cpu",))
    path = os.path.join(out, serving.MANIFEST)
    meta = json.load(open(path))
    assert meta[serving.INT8_OPERANDS] == quant.OPERAND_LAYOUT != layout
    call, _ = serving.load_serving_program(out, "cpu")
    x = torch.randn(4, 5)
    assert torch.equal(call(x), fn(x))
    if layout is None:
        del meta[serving.INT8_OPERANDS]
    else:
        meta[serving.INT8_OPERANDS] = layout
    json.dump(meta, open(path, "w"))
    with pytest.raises(RuntimeError, match="export it again"):
        serving.load_serving_program(out, "cpu")
