"""R training on the port (optim/, train/, training-mode modules, the
train_r CLI) against the JAX package, at small geometry on the CPU. Inputs
are numpy arrays from a seed, fed to both packages. Tolerances: BatchNorm
f32 1e-5 and bf16 1e-2 of the output's scale (bf16 rounds once at the same
place in both, but the f32 sums before it run in another order); the
optimizers and transforms 1e-6 relative (the same f32 operations in the
same order, the f32 pow of adam's step size and the penalty's sum order
aside); a whole f32 train step 1e-5 of scale after 1 and 3 steps."""
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
from ganreverser_tpu.cli import train_r as j_train_r
from ganreverser_tpu.models import modules as jmodules
from ganreverser_tpu.train.losses import mse as j_mse
from ganreverser_tpu_torch import optim as PO
from ganreverser_tpu_torch.cli import common, train_r
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.models import bridge, modules, zoo
from ganreverser_tpu_torch.ops import dropout_kernel as dk
from ganreverser_tpu_torch.train.losses import bce, mse
from ganreverser_tpu_torch.train.r_loop import (calibrate_batchnorm,
                                                make_r_eval_step,
                                                make_r_segment_program,
                                                make_r_train_step)
from ganreverser_tpu_torch.train.state import TrainState

from torch_port_fixtures import one_thread  # noqa: F401

T = torch.from_numpy
DIMS, ND, BATCH = (3, 16, 16), 8, 8


def _close(out, ref, tol):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if out.size:
        err = np.abs(out - ref).max()
        assert err <= tol * max(1.0, np.abs(ref).max()), err


class _SameImages(torch.nn.Module):
    """The port's G held to JAX's images of the latents (f32, 1e-6 of
    scale), which it then hands on: R's training-mode step here moves by up
    to 7e-4 of scale when its images move by half an ulp, so the two
    packages' steps are compared on the same images."""

    def __init__(self, G, jax_images):
        super().__init__()
        self.G, self.jax_images = G, jax_images

    def forward(self, z):
        images = np.array(self.jax_images(jnp.asarray(z.numpy())))
        _close(self.G(z), images, 1e-6)
        return T(images)


def _jax_variables(model, in_shape, seed, rng, amplify=1.0):
    """JAX variables with non-trivial BN stats; ``amplify`` scales the
    kernels so that random images and latents are not near-constant."""
    v, _ = model.init(jax.random.PRNGKey(seed), in_shape)
    state = jax.tree_util.tree_map(
        lambda leaf: rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32),
        v["state"])
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(leaf) * (
            amplify if path[-1].key == "kernel" else 1.0), v["params"])
    return {"params": params, "state": state}


# -- BatchNorm in training ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 5), (4, 5, 3, 7)])
def test_batchnorm_training_matches_jax(rng, dtype, shape):
    f = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    scale, bias = (rng.uniform(0.5, 1.5, f).astype(np.float32),
                   rng.normal(size=f).astype(np.float32))
    state = {"mean": (rng.normal(size=f) * 0.1).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, f).astype(np.float32)}
    jbn = jmodules.BatchNorm(f, dtype=getattr(jnp, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))

    def f_(x_, scale_, bias_):
        y, ns = jbn.apply({"params": {"scale": scale_, "bias": bias_},
                           "state": state}, x_, train=True)
        return jnp.sum(y.astype(jnp.float32) * g), (y, ns)

    (_, (ref_y, ref_state)), ref_grads = jax.value_and_grad(
        f_, argnums=(0, 1, 2), has_aux=True)(jx, scale, bias)

    bn = modules.BatchNorm(f, dtype=getattr(torch, dtype)).train()
    bridge.load_jax_variables(bn, {"params": {"scale": scale, "bias": bias},
                                   "state": state})
    tx = T(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = bn(tx)
    grads = torch.autograd.grad((y.float() * T(g)).sum(),
                                [tx, bn.scale, bn.bias])
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert y.dtype == tx.dtype and grads[0].dtype == tx.dtype
    _close(y.detach().float(), np.asarray(ref_y.astype(jnp.float32)), tol)
    _close(bn.mean, ref_state["mean"], 1e-5)
    _close(bn.var, ref_state["var"], 1e-5)
    for out, ref in zip(grads, ref_grads):
        _close(out.float(), np.asarray(ref.astype(jnp.float32)), tol)


# -- optimizers and transforms ------------------------------------------------

OPT_CASES = [("sgd", {}), ("adagrad", {}), ("adadelta", {}), ("adamax", {}),
             ("adam", {}), ("rmsprop", {}),
             ("sgd", dict(lr=0.02, momentum=0.9, nesterov=True,
                          weight_decay=1e-2, lr_decay=0.1)),
             ("sgd", dict(lr=0.05, momentum=0.5, dampening=0.1)),
             ("adagrad", dict(lr_decay=0.1, weight_decay=1e-2)),
             ("adadelta", dict(weight_decay=1e-2)),
             ("adam", dict(weight_decay=1e-2)),
             ("adamax", dict(weight_decay=1e-2)),
             ("rmsprop", dict(weight_decay=1e-2))]


def _random_tree(rng):
    return {"l0": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                   "bias": rng.normal(size=(4,)).astype(np.float32)},
            "l2": {"scale": rng.normal(size=(5,)).astype(np.float32)}}


def _flat(tree, names):
    return [np.asarray(bridge._lookup(tree, n)) for n in names]


NAMES = ["l0.kernel", "l0.bias", "l2.scale"]


@pytest.mark.parametrize("method,kwargs", OPT_CASES)
def test_optimizers_match_jax(rng, method, kwargs):
    """Three updates on a random tree: the parameters and every state leaf
    against the JAX optimizer of the same name and arguments."""
    params = _random_tree(rng)
    grads = [_random_tree(rng) for _ in range(3)]
    make_j = (getattr(O, method)(**kwargs) if kwargs
              else O.make_optimizer(method))
    make_p = (getattr(PO, method)(**kwargs) if kwargs
              else PO.make_optimizer(method))
    j_state = make_j.init(params)
    j_params = params
    p_params = [T(a.copy()) for a in _flat(params, NAMES)]
    p_state = make_p.init(p_params)
    assert set(p_state) == set(j_state)
    for g in grads:
        updates, j_state = make_j.update(g, j_state, j_params)
        j_params = O.apply_updates(j_params, updates)
        make_p.update([T(a) for a in _flat(g, NAMES)], p_state, p_params)
    for out, ref in zip(p_params, _flat(j_params, NAMES)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)
    for k, v in p_state.items():
        if isinstance(v, list):
            for out, ref in zip(v, _flat(j_state[k], NAMES)):
                np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6,
                                           atol=1e-7)
        else:
            assert v.dtype == torch.int32 and int(v) == int(j_state[k]) == 3


def test_make_optimizer_refuses_unknown_method():
    with pytest.raises(ValueError):
        PO.make_optimizer("lbfgs")


@pytest.mark.parametrize("l1,l2,clamp", [(0.0, 1e-4, 1.0), (1e-3, 0.0, 0.0),
                                         (1e-3, 1e-2, 0.05), (0.0, 0.0, 0.0)])
def test_regularize_matches_jax(rng, l1, l2, clamp):
    params = _random_tree(rng)
    grads = jax.tree_util.tree_map(lambda a: a * 0.1, _random_tree(rng))
    ref_grads, ref_loss = O.regularize(params, grads, jnp.float32(0.75), l1,
                                       l2, clamp)
    out_grads, out_loss = PO.regularize(
        [T(a) for a in _flat(params, NAMES)],
        [T(a) for a in _flat(grads, NAMES)], torch.tensor(0.75), l1, l2,
        clamp)
    for out, ref in zip(out_grads, _flat(ref_grads, NAMES)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(out_loss), float(ref_loss), rtol=1e-6)
    if clamp:
        assert max(float(g.abs().max()) for g in out_grads) <= np.float32(clamp)


def test_losses_match_jax(rng):
    from ganreverser_tpu.train.losses import bce as j_bce
    o = rng.uniform(size=(6, 4)).astype(np.float32)
    t = (rng.uniform(size=(6, 4)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(float(mse(T(o), T(t))), float(j_mse(o, t)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(bce(T(o), T(t))), float(j_bce(o, t)),
                               rtol=1e-6)
    assert mse(T(o).to(torch.bfloat16), T(t)).dtype == torch.float32


# -- one whole train step -----------------------------------------------------

def _no_dropout(model):
    """The JAX R with every Dropout/SpatialDropout at rate 0."""
    return jmodules.Sequential([
        dataclasses.replace(m, rate=0.0)
        if isinstance(m, (jmodules.Dropout, jmodules.SpatialDropout)) else m
        for m in model.layers])


def test_train_step_matches_jax(rng):
    """f32, dropouts off (the JAX module sends impl='kernel' to threefry
    off the TPU, so masks cannot be compared inside it): R.apply(train=True),
    mse, value_and_grad, regularize, adam, merge_state against the port's
    step on the same weights, latents and images (``_SameImages``), steps 1
    to 3: parameters, BN buffers, adam m and v, and the loss, within 1e-5 of
    scale.

    Each step starts both packages from one state, the JAX state after the
    previous step carried into the port by ts_from_tree, so step 3 runs
    adam at t = 3 on non-zero moments. adam's first step is lr * sign(g)
    wherever |g| >> eps, so an element whose gradient lies within the f32
    rounding of its sum may step either way in either package: the biases
    before a training-mode BatchNorm (their gradient is zero but for
    rounding) and entries whose gradient, or whose new first moment, is
    near zero. Chaining each package's own states would carry those flips
    into the next forward. So every parameter element is held to adam's
    bound |dp| <= 2 lr, and all but 1 % of them (0.07-0.09 % are off
    here) to 1e-5 of scale."""
    c, h, w = DIMS
    jg, jr = M.create_G(DIMS, ND), _no_dropout(M.create_R(DIMS, ND, "normal"))
    gv, _ = jg.init(jax.random.PRNGKey(1), (ND,))
    # settled BN statistics: images that vary with z, so that R's
    # gradients are well above their rounding
    gv = JT.calibrate_batchnorm(
        jg, gv, lambda k: jax.random.normal(k, (16, ND)),
        jax.random.PRNGKey(2), n_batches=10)
    gv = jax.tree_util.tree_map(np.asarray, gv)
    rv = _jax_variables(jr, (h, w, c), 2, rng)
    zs = [rng.normal(size=(BATCH, ND)).astype(np.float32) for _ in range(3)]
    opt = O.adam()

    @jax.jit
    def jax_step(ts, z):
        images, _ = jg.apply(gv, z, train=False)

        def loss_fn(p, s):
            out, ns = jr.apply({"params": p, "state": s}, images, train=True,
                               rng=jax.random.PRNGKey(0))
            return j_mse(out, z), ns

        (loss, ns), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            ts.params, ts.state)
        grads, loss = O.regularize(ts.params, grads, loss, 0.0, 1e-4, 1.0)
        updates, opt_state = opt.update(grads, ts.opt_state, ts.params)
        return JT.TrainState(params=O.apply_updates(ts.params, updates),
                             state=JT.merge_state(ts.state, ns),
                             opt_state=opt_state, step=ts.step + 1), loss

    G = bridge.load_jax_variables(zoo.create_G3(DIMS, ND), gv)
    R = bridge.load_jax_variables(zoo.create_R(DIMS, ND, "normal"), rv)
    for m in R.modules():
        if isinstance(m, modules.Dropout):
            m.rate = 0.0
    jax_images = jax.jit(lambda z: jg.apply(gv, z, train=False)[0])
    step = make_r_train_step(_SameImages(G, jax_images), dtype=torch.float32)
    jts = JT.TrainState.create(rv, opt)
    leaves = jax.tree_util.tree_leaves
    for i, z in enumerate(zs):
        ts = common.ts_from_tree(
            jax.tree_util.tree_map(np.asarray, jcommon.ts_to_tree(jts)), R,
            PO.adam(), "cpu")
        jts, ref_loss = jax_step(jts, jnp.asarray(z))
        loss = step(ts, T(z))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
        tree = common.ts_to_tree(ts)
        n_off = n_all = 0
        for ref, out in zip(leaves(jts.params), leaves(tree["params"])):
            diff = np.abs(np.asarray(out) - np.asarray(ref))
            n_off += int((diff > 1e-5 * max(1.0, np.abs(ref).max())).sum())
            n_all += diff.size
            assert diff.max() <= 2e-3 + 1e-6
        assert n_off < 0.01 * n_all, (i, n_off, n_all)
        for ref, out in zip(leaves(jts.state), leaves(tree["state"])):
            _close(out, ref, 1e-5)
        for k in ("m", "v"):
            for ref, out in zip(leaves(jts.opt_state[k]),
                                leaves(tree["opt_state"][k])):
                _close(out, ref, 1e-5)
        assert int(tree["step"]) == int(jts.step) == i + 1
        assert int(tree["opt_state"]["step"]) == i + 1


# -- dropouts of R in training -----------------------------------------------

@pytest.mark.parametrize("fixer", [False, True])
def test_kernel_masks_inside_R(fixer):
    """R(impl='kernel') in training: each element dropout's output is
    fused_dropout_plain(its input, the seed it drew), the seeds drawn from
    the generator set on R in layer order; the SpatialDropout drops whole
    (sample, channel) maps from the same generator."""
    R = modules.init_parameters(
        zoo.create_R(DIMS, ND, "normal", fixer=fixer, dropout_impl="kernel"),
        torch.Generator().manual_seed(0))
    modules.set_dropout_generator(R.train(), torch.Generator().manual_seed(3))
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((mod, inp[0], out)))
        for m in R.modules() if isinstance(m, modules.Dropout)]
    x = torch.rand(4, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    R(x)
    for hk in hooks:
        hk.remove()
    assert len(seen) == 6 + 1 + fixer
    replay = torch.Generator().manual_seed(3)
    for mod, inp, out in seen:
        if isinstance(mod, modules.SpatialDropout):
            shape = (inp.shape[0], 1, 1, inp.shape[-1])
            keep = modules.dropout_keep_mask(shape, 0.25, replay, "cpu")
            ref = modules.apply_dropout(inp, keep, 0.25)
            maps = (out.abs().sum(dim=(1, 2)) == 0)
            assert maps.any() and not maps.all()
        else:
            ref = dk.fused_dropout_plain(inp, dk.draw_seed(replay, "cpu"),
                                         mod.rate)
        assert torch.equal(out, ref)


def test_dropouts_need_a_generator_and_stay_off_in_evaluation():
    R = zoo.create_R((1, 8, 8), ND, "normal", dropout_impl="kernel")
    x = torch.rand(2, 8, 8, 1)
    with pytest.raises(ValueError):
        R.train()(x)
    R.eval()
    with torch.no_grad():
        for m in R.modules():
            if isinstance(m, modules.Dropout):
                assert torch.equal(m(x), x)
    with pytest.raises(ValueError):
        modules.Dropout(0.5, impl="threefry")


# -- learning and the segment program ------------------------------------------

@pytest.fixture(scope="module")
def calibrated_g():
    """A random port G3 at 1x8x8, noise 8, its BN statistics settled by
    calibrate_batchnorm (so that G(z) varies with z)."""
    dims = (1, 8, 8)
    G = modules.init_parameters(zoo.create_G3(dims, ND),
                                torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    calibrate_batchnorm(G, lambda i: torch.randn(16, ND, generator=gen), 40)
    assert not G.training
    return G, dims


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_r_training_reduces_loss(calibrated_g, impl):
    """tests/test_train.py's bar for the JAX trainer: after 150 steps of
    batch 16 the evaluation MSE on held-out latents is below the
    predict-zero loss (Var z = 1), here with either dropout."""
    G, dims = calibrated_g
    R = zoo.create_R(dims, ND, "normal", dropout_impl=impl)
    modules.init_parameters(R, torch.Generator().manual_seed(2))
    modules.set_dropout_generator(R, torch.Generator().manual_seed(4))
    z_eval = torch.randn(128, ND, generator=torch.Generator().manual_seed(99))
    invert = make_r_eval_step(R)

    def eval_mse():
        with torch.no_grad():
            return float(((invert(G(z_eval)) - z_eval) ** 2).mean())

    ts = TrainState.create(R, PO.adam())
    loss0 = eval_mse()
    segment = make_r_segment_program(G, batch_size=16, noise_dim=ND,
                                     noise_method="normal",
                                     dtype=torch.float32)
    losses = segment(ts, torch.Generator().manual_seed(5), 150)
    assert losses.shape == (150,) and torch.isfinite(losses).all()
    loss1 = eval_mse()
    assert loss1 < loss0 and loss1 < 0.95, (loss0, loss1)
    assert ts.step == 150 and int(ts.opt_state["step"]) == 150
    assert not R.training


def test_segment_program_chains(calibrated_g):
    G, dims = calibrated_g
    R = modules.init_parameters(
        zoo.create_R(dims, ND, "uniform", dtype=torch.bfloat16),
        torch.Generator().manual_seed(2))
    modules.set_dropout_generator(R, torch.Generator().manual_seed(4))
    ts = TrainState.create(R, PO.adam())
    segment = make_r_segment_program(G, batch_size=4, noise_dim=ND,
                                     noise_method="uniform",
                                     dtype=torch.bfloat16, r_l1=1e-4)
    gen = torch.Generator().manual_seed(5)
    a = segment(ts, gen, 3)
    b = segment(ts, gen, 2)
    assert a.shape == (3,) and b.shape == (2,) and ts.step == 5
    assert a.dtype == torch.float32 and torch.isfinite(torch.cat([a, b])).all()
    with torch.no_grad():
        out = R.eval()(G(torch.zeros(2, ND)))
    assert out.dtype == torch.bfloat16 and out.abs().max() <= 1.0


# -- checkpoints both ways ------------------------------------------------------

def test_train_state_tree_round_trip(calibrated_g, tmp_path):
    """ts_to_tree keeps int32 step counts and f32 leaves; written and read
    back, it restores the same module, moments and steps; a tree of
    another optimizer is refused."""
    G, dims = calibrated_g
    R = modules.init_parameters(zoo.create_R(dims, ND, "normal"),
                                torch.Generator().manual_seed(2))
    modules.set_dropout_generator(R, torch.Generator().manual_seed(4))
    ts = TrainState.create(R, PO.adam())
    make_r_train_step(G, dtype=torch.float32)(ts, torch.randn(4, ND))
    path = str(tmp_path / "r")
    ckpt.save_checkpoint(path, {"R": common.ts_to_tree(ts)})
    tree = ckpt.load_checkpoint(path)[0]["R"]
    assert tree["step"].dtype == np.int32 and int(tree["step"]) == 1
    assert tree["opt_state"]["step"].dtype == np.int32
    assert tree["opt_state"]["m"]["l0"]["kernel"].dtype == np.float32
    back = common.ts_from_tree(tree, zoo.create_R(dims, ND, "normal"),
                               PO.adam(), "cpu")
    assert back.step == 1 and back.opt_state["step"].dtype == torch.int32
    for a, b in zip(back.module.state_dict().values(),
                    R.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(back.opt_state["v"], ts.opt_state["v"]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        common.ts_from_tree(tree, zoo.create_R(dims, ND, "normal"),
                            PO.rmsprop(), "cpu")
    assert bridge.to_torch({"s": np.int64(3)}, "cpu")["s"].dtype == \
        torch.int32


def test_port_checkpoint_loads_in_jax(calibrated_g, tmp_path):
    """A port-trained R checkpoint (the port's CLI) loads in JAX through
    its ts_from_tree, gives the port's evaluation outputs to 1e-5 through
    its make_r_eval_step, and takes a JAX train step from there."""
    G, dims = calibrated_g
    c, h, w = dims
    save = str(tmp_path / "logs")
    ckpt.save_checkpoint(ckpt.adversarial_name(save),
                         {"G": bridge.export_variables(G)},
                         config={"noiseDim": ND, "noiseMethod": "normal",
                                 "colorSpace": "y", "height": h, "width": w})
    out = train_r.main(["--G", ckpt.adversarial_name(save), "--save", save,
                        "--nbBatches", "4", "--batchSize", "4", "--noplot",
                        "--dropout", "kernel"])
    tree, _, extra = gio.load_checkpoint(out["checkpoint"])
    assert extra["batch"] == 4
    jts = jcommon.ts_from_tree(tree["R"])
    jr = M.create_R(dims, ND, "normal")
    x = np.random.default_rng(3).uniform(size=(5, h, w, c)).astype(np.float32)
    ref = np.asarray(JT.make_r_eval_step(jr)(jts.variables, jnp.asarray(x)))
    port = make_r_eval_step(out["ts"].module)(T(x)).numpy()
    _close(port, ref, 1e-5)
    jg = M.create_G(dims, ND)
    step = JT.make_r_train_step(jg, jr, batch_size=4, noise_dim=ND,
                                noise_method="normal")
    gv = jax.tree_util.tree_map(jnp.asarray, bridge.export_variables(G))
    jts2, loss = step(gv, jts, jax.random.PRNGKey(0))
    assert np.isfinite(float(loss)) and int(jts2.step) == 5


def test_jax_checkpoint_resumes_in_port_cont(tmp_path, rng):
    """A JAX train_r checkpoint continues in the port's --cont with the
    same step, params and adam m/v, and trains on from there."""
    dims = (1, 8, 8)
    c, h, w = dims
    save = str(tmp_path / "logs")
    jg = M.create_G(dims, ND)
    gio.save_checkpoint(gio.adversarial_name(save),
                        {"G": _jax_variables(jg, (ND,), 5, rng, 2.0),
                         "D": {}},
                        config={"noiseDim": ND, "noiseMethod": "normal",
                                "colorSpace": "y", "height": h, "width": w})
    g_path = gio.adversarial_name(save)
    j_train_r.main(["--G", g_path, "--save", save, "--nbBatches", "3",
                    "--batchSize", "4", "--noplot", "--prng", "threefry"])
    r_path = gio.r_name(save, c, h, w, ND, "normal", False)
    j_tree = gio.load_checkpoint(r_path)[0]["R"]
    out = train_r.main(["--G", g_path, "--save", str(tmp_path / "port"),
                        "--cont", r_path, "--nbBatches", "0"])
    assert out["ts"].step == 3 and out["losses"] == []
    p_tree = ckpt.load_checkpoint(out["checkpoint"])[0]["R"]
    assert int(p_tree["step"]) == int(j_tree["step"]) == 3
    for part in ("params", "state", "opt_state"):
        jl = jax.tree_util.tree_leaves(j_tree[part])
        pl_ = jax.tree_util.tree_leaves(p_tree[part])
        assert len(jl) == len(pl_)
        for a, b in zip(pl_, jl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    more = train_r.main(["--G", g_path, "--save", str(tmp_path / "port"),
                         "--cont", r_path, "--nbBatches", "2",
                         "--batchSize", "4", "--noplot"])
    assert more["ts"].step == 5 and np.isfinite(more["losses"]).all()


# -- the CLI --------------------------------------------------------------------

@pytest.fixture(scope="module")
def g_checkpoint(tmp_path_factory):
    """A JAX-written 1x8x8 G checkpoint whose BN statistics were settled
    by the JAX calibrate_batchnorm."""
    save = str(tmp_path_factory.mktemp("train_r") / "logs")
    G = M.create_G((1, 8, 8), ND)
    key = jax.random.PRNGKey(0)
    gv, _ = G.init(key, (ND,))
    gv = JT.calibrate_batchnorm(
        G, gv, lambda k: jax.random.normal(k, (16, ND)), key, n_batches=10)
    gio.save_checkpoint(gio.adversarial_name(save),
                        {"G": jax.tree_util.tree_map(np.asarray, gv),
                         "D": {}},
                        config={"noiseDim": ND, "noiseMethod": "normal",
                                "colorSpace": "y", "height": 8, "width": 8})
    return save


def _events(save):
    with open(os.path.join(save, "events_r.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("fixer", [False, True])
def test_cli_writes_every_artifact(g_checkpoint, tmp_path, capsys, fixer):
    save = str(tmp_path / "logs")
    args = ["--G", gio.adversarial_name(g_checkpoint), "--save", save,
            "--nbBatches", "100", "--batchSize", "8", "--saveFreq", "50",
            "--dropout", "kernel"] + (["--fixer"] if fixer else [])
    out = train_r.main(args)
    printed = capsys.readouterr().out
    assert "Example:" in printed and "Noise for G:" in printed
    assert "Result by R:" in printed and "--prng rbg" in printed
    name = "r_1x8x8_nd8_normal" + ("_fixer" if fixer else "")
    assert out["checkpoint"] == os.path.join(save, name)
    tree, cfg, extra = ckpt.load_checkpoint(out["checkpoint"])
    assert extra["batch"] == 100 and len(extra["plot_data"]) == 1
    assert extra["plot_data"][0][0] == 100 and cfg["fixer"] == fixer
    assert cfg["noiseDim"] == ND and cfg["colorSpace"] == "y"
    assert os.path.isdir(out["checkpoint"] + ".old")  # saved at 50 and 100
    images = sorted(os.listdir(os.path.join(save, "images_r")))
    assert images == ["g_r_g_000025.png", "g_r_g_000050.png",
                      "g_r_g_000075.png", "g_r_g_000100.png",
                      "plot_r_loss.png"]
    tags = [(r["tag"], r.get("step")) for r in _events(save)]
    assert tags == [("r_batch_time", 100), ("r_loss_low", 100),
                    ("r_loss_avg", 100), ("r_loss_high", 100)]
    assert len(out["losses"]) == 100 and np.isfinite(out["losses"]).all()
    assert dk.fused_dropout.launches == 0  # the CPU runs the plain version


def test_cli_cont_continues_plot_data(g_checkpoint, tmp_path):
    save = str(tmp_path / "logs")
    base = ["--G", gio.adversarial_name(g_checkpoint), "--save", save,
            "--batchSize", "4", "--saveFreq", "100"]
    first = train_r.main(base + ["--nbBatches", "100", "--noplot"])
    out = train_r.main(base + ["--nbBatches", "100", "--cont",
                               first["checkpoint"]])
    tree = ckpt.load_checkpoint(out["checkpoint"])[0]["R"]
    extra = ckpt.load_checkpoint(out["checkpoint"])[2]
    assert out["ts"].step == 200 and int(tree["step"]) == 200
    assert int(tree["opt_state"]["step"]) == 200 and extra["batch"] == 200
    assert [row[0] for row in extra["plot_data"]] == [100, 200]
    assert os.path.isfile(os.path.join(save, "images_r", "plot_r_loss.png"))


@pytest.mark.parametrize("flags", [["--mesh_data", "2"], ["--mesh_model", "2"],
                                   ["--async_save"],
                                   ["--coordinator_address", "localhost:1"],
                                   ["--dropout", "rbg"]])
def test_cli_refuses_unported_flags(g_checkpoint, tmp_path, flags):
    """An unknown --dropout is refused; no mesh flag is refused as
    unported any more. One process is one rank: a mesh larger than it, and
    a coordinator without a process count, are refused with the JAX
    package's messages before anything is written; --async_save trains and
    writes its checkpoint."""
    args = ["--G", gio.adversarial_name(g_checkpoint), "--save",
            str(tmp_path), "--nbBatches", "1"] + flags
    refused = {"--mesh_data 2": "mesh (2 data x 1 model) does not fit 1 "
                                "devices",
               "--mesh_model 2": "model axis 2 exceeds the 1 available "
                                 "devices",
               "--coordinator_address localhost:1": "--coordinator_address "
               "needs --num_processes > 0 and --process_id >= 0 (got 0, -1)"}
    if flags == ["--async_save"]:
        out = train_r.main(args)
        assert int(ckpt.load_checkpoint(out["checkpoint"])[2]["batch"]) == 1
        return
    if flags[0] == "--dropout":
        with pytest.raises(SystemExit):
            train_r.main(args)
    else:
        with pytest.raises(ValueError) as e:
            train_r.main(args)
        assert str(e.value) == refused[" ".join(flags)]
    assert not os.path.exists(os.path.join(str(tmp_path), "events_r.jsonl"))
