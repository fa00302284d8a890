"""The pretraining path of the port (models/zoo.create_G_encoder,
train/pretrain_ae.py, train/pretrain_distill.py, the fast G with U's fused
head, data/colorspace.switch_colorspace, cli/pretrain_g.py and
cli/pretrain_prev.py) against the JAX package at small geometry on the
CPU. Inputs, latents and targets are numpy arrays from a seed, handed to
both packages.

Tolerances, relative to max(1, max |JAX|): forwards in f32 1e-4 (f32 sums
in another order); the steps 1e-5 for the losses, BN statistics and adam's
moments. The parameters after each step carry adam's caveat
(tests/test_torch_port_train_r.py): adam's first steps are lr * sign(g),
so an element whose gradient is rounding noise (the biases before a
training-mode BatchNorm) may step either way, and every element is held to
adam's bound of 2 lr and all but 2 % of them to 1e-5 of scale."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import io as gio
from ganreverser_tpu import models as M
from ganreverser_tpu import optim as O
from ganreverser_tpu import train as JT
from ganreverser_tpu.cli import common as jcommon
from ganreverser_tpu.cli import train as j_train
from ganreverser_tpu.cli.pretrain_prev import _resize_batch as j_resize
from ganreverser_tpu.data import switch_colorspace as j_switch
from ganreverser_tpu.models import modules as jmodules
from ganreverser_tpu_torch import optim as PO
from ganreverser_tpu_torch.cli import common, pretrain_g, pretrain_prev
from ganreverser_tpu_torch.core.prng import noise_inputs
from ganreverser_tpu_torch.data.colorspace import (rgb_to_colorspace,
                                                   switch_colorspace)
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
from ganreverser_tpu_torch.ops import conv_kernel, upsample_conv_kernel
from ganreverser_tpu_torch.train import pretrain_ae, pretrain_distill

from torch_port_fixtures import one_thread  # noqa: F401

T = torch.from_numpy
DIMS, ND, BATCH = (3, 16, 16), 8, 8
leaves = jax.tree_util.tree_leaves


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _variables(model, in_shape, seed, rng):
    """JAX variables with non-trivial BN running statistics, as numpy."""
    v, _ = model.init(jax.random.PRNGKey(seed), in_shape)
    state = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim and a.size
                   else a).astype(np.float32), v["state"])
    for layer in state.values() if isinstance(state, dict) else ():
        if isinstance(layer, dict) and "mean" in layer:
            layer["mean"] = (rng.normal(size=layer["mean"].shape) * 0.1
                             ).astype(np.float32)
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
            "state": state}


def _images(seed, n, dims=DIMS):
    c, h, w = dims
    return np.random.default_rng(seed).uniform(size=(n, h, w, c)).astype(
        np.float32)


def _no_dropout(m):
    if isinstance(m, (jmodules.Dropout, jmodules.SpatialDropout)):
        return dataclasses.replace(m, rate=0.0)
    if isinstance(m, jmodules.Sequential):
        return jmodules.Sequential([_no_dropout(x) for x in m.layers])
    if isinstance(m, jmodules.ConcatBranches):
        return jmodules.ConcatBranches([_no_dropout(b) for b in m.branches])
    return m


def _port_no_dropout(module):
    for m in module.modules():
        if isinstance(m, modules.Dropout):
            m.rate = 0.0
    return module


def _assert_step_matches(jts, ts, i, lr=1e-3):
    """The port's train state after step i + 1 against JAX's: parameters
    with adam's caveat, BN statistics and moments within 1e-5 of scale."""
    tree = common.ts_to_tree(ts)
    n_off = n_all = 0
    for ref, out in zip(leaves(jts.params), leaves(tree["params"])):
        diff = np.abs(np.asarray(out) - np.asarray(ref))
        n_off += int((diff > 1e-5 * max(1.0, np.abs(ref).max())).sum())
        n_all += diff.size
        assert diff.max() <= 2 * lr + 1e-6
    assert n_off < 0.02 * n_all, (i, n_off, n_all)
    for ref, out in zip(leaves(jts.state), leaves(tree["state"])):
        _close(out, ref, 1e-5)
    for k in jts.opt_state:
        if k == "step":
            continue
        for ref, out in zip(leaves(jts.opt_state[k]),
                            leaves(tree["opt_state"][k])):
            _close(out, ref, 1e-5)
    assert int(tree["step"]) == int(jts.step) == i + 1


# -- the fast G ---------------------------------------------------------------

@pytest.mark.parametrize("dims", [(3, 16, 16), (1, 8, 8)])
def test_fast_generator_matches_jax_g3(rng, dims):
    """make_fast_generator (kernel U and U's fused head, their plain
    versions on the CPU) against create_G3(...).apply(train=False), f32
    within 1e-4; no kernel launch on the CPU."""
    gv = _variables(M.create_G3(dims, ND), (ND,), 0, rng)
    z = rng.normal(size=(5, ND)).astype(np.float32)
    ref, _ = M.create_G3(dims, ND).apply(gv, jnp.asarray(z), train=False)
    before = (upsample_conv_kernel.upsample2_conv3x3_bn_act.launches,
              upsample_conv_kernel.upsample2_conv3x3_head.launches)
    out = fastpath.make_fast_generator(dims, ND, torch.float32)(
        bridge.to_torch(gv, "cpu"), T(z))
    assert out.shape == (5, dims[1], dims[2], dims[0])
    _close(out, ref, 1e-4)
    assert (upsample_conv_kernel.upsample2_conv3x3_bn_act.launches,
            upsample_conv_kernel.upsample2_conv3x3_head.launches) == before


# -- G_encoder ------------------------------------------------------------------

def test_g_encoder_matches_jax(rng):
    """create_G_encoder against the JAX encoder: the layer tree, the
    parameter count, the evaluation forward, and the training forward
    (output and the BN running statistics it moves), f32."""
    je = M.create_G_encoder(DIMS, ND)
    c, h, w = DIMS
    ev = _variables(je, (h, w, c), 1, rng)
    x = _images(2, 6)
    E = bridge.load_jax_variables(zoo.create_G_encoder(DIMS, ND), ev)
    assert sum(p.numel() for p in E.parameters()) == \
        M.count_parameters(ev["params"])
    ref, _ = je.apply(ev, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = E(T(x))
    assert out.shape == (6, ND) and not E.training
    _close(out, ref, 1e-4)
    ref_t, ref_state = je.apply(ev, jnp.asarray(x), train=True,
                                rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        out_t = E.train()(T(x))
    _close(out_t, ref_t, 1e-4)
    back = bridge.export_variables(E)["state"]
    for layer, st in ref_state.items():
        for k in ("mean", "var"):
            _close(back[layer][k], st[k], 1e-5)


# -- the steps against JAX ------------------------------------------------------

def _ae(dims=DIMS):
    return pretrain_ae.make_autoencoder(zoo.create_G_encoder(dims, ND),
                                        zoo.create_G(dims, ND))


@pytest.mark.parametrize("method", ["adam", "adagrad"])
def test_ae_steps_match_jax(rng, method):
    """make_ae_train_step against the JAX step on the same weights and
    images, f32, G_L2 1e-4 and the default clamp: steps 1 to 3, each
    started from the JAX state; decoder_variables is the JAX tree's l1."""
    jae = JT.make_autoencoder(M.create_G_encoder(DIMS, ND),
                              M.create_G(DIMS, ND))
    c, h, w = DIMS
    v, _ = jae.init(jax.random.PRNGKey(3), (h, w, c))
    jopt = O.adagrad() if method == "adagrad" else O.adam()
    popt = PO.adagrad() if method == "adagrad" else PO.adam()
    jstep = JT.make_ae_train_step(jae, g_l2=1e-4, opt=jopt)
    step = pretrain_ae.make_ae_train_step(dtype=torch.float32, g_l2=1e-4,
                                          opt=popt)
    jts = JT.TrainState.create(v, jopt)
    for i in range(3):
        x = _images(10 + i, BATCH)
        ts = common.ts_from_tree(
            jax.tree_util.tree_map(np.asarray, jcommon.ts_to_tree(jts)),
            _ae(), popt, "cpu")
        jts, ref_loss = jstep(jts, jnp.asarray(x), jax.random.PRNGKey(i))
        loss = step(ts, T(x))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        _assert_step_matches(jts, ts, i, lr=1e-2 if method == "adagrad"
                             else 1e-3)
    dec = pretrain_ae.decoder_variables(ts.module)
    ref = JT.decoder_variables({"params": jts.params, "state": jts.state})
    assert set(dec["params"]) == set(ref["params"])
    assert sum(a.size for a in leaves(dec)) == sum(
        np.asarray(a).size for a in leaves(ref))


def test_distill_steps_match_jax(rng):
    """make_distill_g_step (MSE against given targets) and
    make_distill_d_step (BCE against given soft targets, dropouts off)
    against the JAX steps, f32, the CLI's penalties: steps 1 to 3."""
    jg, jd = M.create_G(DIMS, ND), _no_dropout(M.create_D(DIMS))
    c, h, w = DIMS
    gv, _ = jg.init(jax.random.PRNGKey(4), (ND,))
    dv, _ = jd.init(jax.random.PRNGKey(5), (h, w, c))
    jg_step = JT.make_distill_g_step(jg, g_l1=0.0, g_l2=0.0, g_clamp=5.0)
    jd_step = JT.make_distill_d_step(jd, d_l1=0.0, d_l2=1e-4, d_clamp=1.0)
    g_step = pretrain_distill.make_distill_g_step(dtype=torch.float32)
    d_step = pretrain_distill.make_distill_d_step(dtype=torch.float32)
    jgts = JT.TrainState.create(gv, O.adam())
    jdts = JT.TrainState.create(dv, O.adam())
    for i in range(3):
        z = rng.normal(size=(BATCH, ND)).astype(np.float32)
        targets = _images(20 + i, BATCH)
        soft = rng.uniform(0.05, 0.95, BATCH).astype(np.float32)
        gts = common.ts_from_tree(
            jax.tree_util.tree_map(np.asarray, jcommon.ts_to_tree(jgts)),
            zoo.create_G(DIMS, ND), PO.adam(), "cpu")
        dts = common.ts_from_tree(
            jax.tree_util.tree_map(np.asarray, jcommon.ts_to_tree(jdts)),
            _port_no_dropout(zoo.create_D(DIMS)), PO.adam(), "cpu")
        jgts, ref_gl = jg_step(jgts, jnp.asarray(z), jnp.asarray(targets),
                               jax.random.PRNGKey(i))
        jdts, ref_dl = jd_step(jdts, jnp.asarray(targets), jnp.asarray(soft),
                               jax.random.PRNGKey(i))
        gl = g_step(gts, T(z), T(targets))
        dl = d_step(dts, T(targets), T(soft))
        np.testing.assert_allclose(float(gl), float(ref_gl), rtol=1e-5)
        np.testing.assert_allclose(float(dl), float(ref_dl), rtol=1e-5)
        _assert_step_matches(jgts, gts, i)
        _assert_step_matches(jdts, dts, i)


# -- helpers --------------------------------------------------------------------

@pytest.mark.parametrize("new_nd,prev_nd,methods", [
    (12, 5, ("normal", "uniform")), (3, 6, ("normal", "normal"))])
def test_paired_noise_copies_the_shared_components(new_nd, prev_nd,
                                                   methods):
    """prev_z then new_z from one generator, new_z's leading
    min(new_nd, prev_nd) components replaced by prev_z's (the JAX rule,
    tests/test_pretrain_units.py), the rest as drawn."""
    new_method, prev_method = methods
    prev_z, new_z = pretrain_distill.paired_noise(
        torch.Generator().manual_seed(0), 8, new_nd, new_method, prev_nd,
        prev_method)
    gen = torch.Generator().manual_seed(0)
    p_ref = noise_inputs(gen, 8, prev_nd, prev_method)
    n_ref = noise_inputs(gen, 8, new_nd, new_method)
    shared = min(new_nd, prev_nd)
    assert prev_z.shape == (8, prev_nd) and new_z.shape == (8, new_nd)
    assert torch.equal(prev_z, p_ref)
    assert torch.equal(new_z[:, :shared], prev_z[:, :shared])
    assert torch.equal(new_z[:, shared:], n_ref[:, shared:])
    if prev_method == "uniform":
        assert prev_z.abs().max() <= 1.0


def test_switch_colorspace_and_resize_match_jax(rng):
    """switch_colorspace for every pair of colour spaces, on images that
    are RGB images in the source space, and _resize_batch up, down and at
    the same size, against the JAX package's (whose C++ paths sum in
    another order): 1e-6."""
    rgb = rng.uniform(size=(3, 5, 4, 3)).astype(np.float32)
    for src in ("rgb", "yuv", "hsl", "y"):
        x = rgb_to_colorspace(rgb, src)
        for dst in ("rgb", "yuv", "hsl", "y"):
            np.testing.assert_allclose(switch_colorspace(x, src, dst),
                                       j_switch(x, src, dst), rtol=1e-6,
                                       atol=1e-6)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    for h, w in ((16, 16), (4, 6)):
        out = pretrain_prev._resize_batch(x, h, w)
        assert out.dtype == np.float32 and out.shape == (2, h, w, 3)
        np.testing.assert_allclose(out, j_resize(x, h, w), rtol=1e-6,
                                   atol=1e-6)
    assert pretrain_prev._resize_batch(x, 8, 8) is x


# -- the CLIs -------------------------------------------------------------------

GEOM = ["--dataset", "synthetic", "--colorSpace", "y", "--height", "8",
        "--width", "8", "--noiseDim", str(ND), "--batchSize", "8",
        "--N_epoch", "2"]


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _jax_train_epochs0(save, extra=()):
    """The JAX trainer with --epochs 0: it saves its starting weights (the
    warm start it found) at once."""
    j_train.main(GEOM + ["--save", save, "--epochs", "0", "--noplot",
                         *extra])
    return gio.load_checkpoint(gio.adversarial_name(save))[0]


def test_pretrain_g_cli(tmp_path, capsys):
    """Two epochs with the artifacts, a --network resume continuing the
    loss history, the decoder checkpoint loading in the JAX train as its G
    warm start; and a JAX-written g_pretrained resuming in the port."""
    save = str(tmp_path / "logs")
    out = pretrain_g.main(GEOM + ["--save", save, "--epochs", "2",
                                  "--saveFreq", "1"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    path = out["checkpoint"]
    assert path == ckpt.g_pretrained_name(save, 1, 8, 8, ND)
    assert sorted(os.listdir(os.path.join(save, "images_pretrain_g"))) == [
        "ae_recon_000001.png", "ae_recon_000002.png", "plot_g_loss.png"]
    assert [r["tag"] for r in _events(os.path.join(
        save, "events_pretrain_g.jsonl"))] == ["ae_loss", "ae_loss"]
    tree, cfg, extra = ckpt.load_checkpoint(path)
    assert set(tree) == {"params", "state"} and cfg["noiseDim"] == ND
    assert extra["epoch"] == 3 and [r[0] for r in extra["plot_data"]] == [1, 2]
    dec = bridge.export_variables(out["ts"].module.l1)
    for a, b in zip(leaves(tree), leaves(dec)):
        np.testing.assert_array_equal(a, b)

    out2 = pretrain_g.main(GEOM + ["--save", save, "--epochs", "1",
                                   "--network", path, "--noplot"])
    assert "resumed decoder" in capsys.readouterr().out
    _, _, extra2 = ckpt.load_checkpoint(out2["checkpoint"])
    assert [r[0] for r in extra2["plot_data"]] == [1, 2, 3]

    jsave = str(tmp_path / "jax")
    jtree = _jax_train_epochs0(jsave, ["--G_pretrained_dir", save])
    for a, b in zip(leaves(jtree["G"]["params"]),
                    leaves(ckpt.load_checkpoint(path)[0]["params"])):
        np.testing.assert_array_equal(a, b)

    gv = _variables(M.create_G((1, 8, 8), ND), (ND,), 6,
                    np.random.default_rng(0))
    jpath = gio.g_pretrained_name(str(tmp_path / "jg"), 1, 8, 8, ND)
    gio.save_checkpoint(jpath, gv, extra={"epoch": 4,
                                          "plot_data": [[1, 0.5]]})
    out3 = pretrain_g.main(GEOM + ["--save", str(tmp_path / "p3"),
                                   "--epochs", "0", "--network", jpath])
    tree3, _, extra3 = ckpt.load_checkpoint(out3["checkpoint"])
    for a, b in zip(leaves(tree3), leaves(gv)):
        np.testing.assert_array_equal(a, b)
    assert extra3["plot_data"] == [[1, 0.5]]


@pytest.mark.parametrize("argv", [["--epochs", "0"]])
def test_pretrain_g_refuses_a_dataset_smaller_than_a_batch(tmp_path, argv,
                                                           monkeypatch):
    from ganreverser_tpu_torch.data import dataset as ds
    monkeypatch.setattr(ds.Dataset, "load_random_images",
                        lambda self, n: np.zeros((3, 8, 8, 1), np.float32))
    with pytest.raises(SystemExit):
        pretrain_g.main(GEOM + ["--save", str(tmp_path), "--epochs", "1"])
    pretrain_g.main(GEOM + ["--save", str(tmp_path)] + argv)


def test_pretrain_prev_cli_across_packages(tmp_path, capsys):
    """A JAX-written adversarial checkpoint (y, 8x8, noise 8) distilled by
    the port into yuv at 16x16 with noise 6: the log lines and scalars of
    every 10th batch, the checkpoint at saveFreq and at the end, no kernel
    launch on the CPU; the result warm-starts the JAX train."""
    dims = (1, 8, 8)
    gs = JT.GanState(
        g=JT.TrainState.create(_variables(M.create_G(dims, ND), (ND,), 7,
                                          np.random.default_rng(1)),
                               O.adam()),
        d=JT.TrainState.create(M.create_D(dims).init(
            jax.random.PRNGKey(8), (8, 8, 1))[0], O.adam()))
    prev = gio.adversarial_name(str(tmp_path / "prev"))
    gio.save_checkpoint(prev, jcommon.gan_to_tree(gs), config={
        "noiseDim": ND, "noiseMethod": "normal", "colorSpace": "y",
        "height": 8, "width": 8})
    save = str(tmp_path / "logs")
    before = (upsample_conv_kernel.upsample2_conv3x3_head.launches,
              conv_kernel.conv3x3_bn_act.launches)
    out = pretrain_prev.main(["--network", prev, "--dataset", "synthetic",
                              "--save", save, "--N_batches", "20",
                              "--batchSize", "8", "--noiseDim", "6",
                              "--colorSpace", "yuv", "--height", "16",
                              "--width", "16", "--saveFreq", "10"])
    printed = capsys.readouterr().out
    assert "<batch 20 of 20> loss G: " in printed
    assert printed.count("saving network to") == 3
    assert (upsample_conv_kernel.upsample2_conv3x3_head.launches,
            conv_kernel.conv3x3_bn_act.launches) == before
    assert len(out["g_losses"]) == len(out["d_losses"]) == 20
    assert np.isfinite(out["g_losses"] + out["d_losses"]).all()
    ev = _events(os.path.join(save, "events_pretrain_prev.jsonl"))
    assert [(r["tag"], r["step"]) for r in ev] == [
        ("distill_g_loss", 10), ("distill_d_loss", 10),
        ("distill_g_loss", 20), ("distill_d_loss", 20)]
    path = out["checkpoint"]
    assert path == ckpt.pretrained_name(save, 3, 16, 16, 6)
    tree, cfg, extra = ckpt.load_checkpoint(path)
    assert extra["batches"] == 20 and cfg["colorSpace"] == "yuv"
    assert int(tree["G"]["step"]) == int(tree["D"]["step"]) == 20

    jtree = _jax_train_epochs0(save, ["--colorSpace", "yuv", "--height",
                                      "16", "--width", "16", "--noiseDim",
                                      "6"])
    for net in ("G", "D"):
        for a, b in zip(leaves(jtree[net]["params"]),
                        leaves(tree[net]["params"])):
            np.testing.assert_array_equal(a, b)
