"""D2 and adversarial training on the port (models/{modules,zoo,fastpath,
bridge}.py, train/adversarial.py) against the JAX package, at small
geometry on the CPU. Inputs are numpy arrays from a seed, fed to both
packages; the latents of the steps are drawn by JAX's own key splits and
handed to the port.

Tolerances, relative to max(1, max |JAX|): D2 and the fast D in f32 1e-4
(f32 sums in another order); the fast D in bf16 2e-2 on the
probabilities (the module path rounds after the bias and multiplies by a
bf16 slope, B6 rounds once); one batch pair in f32 1e-5, with the adam
caveat of tests/test_torch_port_train_r.py: adam's first steps are
sign-like, so an element whose gradient is rounding noise (a bias before a
training-mode BatchNorm) or whose two gradients nearly cancel may step
otherwise in the two packages. G's gradients come through D and through
BatchNorms over a batch of 8, so they carry about 1e-4 relative rounding
noise: every element is held to adam's bound of 2 lr, and all but 5 % of
them (up to 1.7 % are off here) to 1e-5 of scale."""
import dataclasses

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
from ganreverser_tpu.core.prng import noise_inputs as j_noise
from ganreverser_tpu.models import modules as jmodules
from ganreverser_tpu_torch import optim as PO
from ganreverser_tpu_torch.cli import common
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
from ganreverser_tpu_torch.ops import conv_kernel
from ganreverser_tpu_torch.train import adversarial as adv
from ganreverser_tpu_torch.train.losses import bce
from ganreverser_tpu_torch.train.state import GanState, TrainState

from torch_port_fixtures import one_thread  # noqa: F401

T = torch.from_numpy
DIMS, ND, BATCH = (3, 16, 16), 8, 8


def _close(out, ref, tol):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _d_variables(seed, dims=DIMS, amplify=3.0):
    """JAX D2 variables: kernels amplified (random-init D2 outputs sit at
    0.5), biases small and random, PReLU slopes in [0.1, 0.4]."""
    c, h, w = dims
    rng = np.random.default_rng(seed)
    v, _ = M.create_D(dims).init(jax.random.PRNGKey(seed), (h, w, c))

    def leaf(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name == "kernel":
            return a * np.float32(amplify)
        if name == "bias":
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return rng.uniform(0.1, 0.4, a.shape).astype(np.float32)
    return {"params": jax.tree_util.tree_map_with_path(leaf, v["params"]),
            "state": {}}


def _no_dropout(m):
    """The JAX module with every Dropout/SpatialDropout at rate 0, through
    Sequential and ConcatBranches."""
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


def _images(seed, n, dims=DIMS):
    c, h, w = dims
    return np.random.default_rng(seed).uniform(size=(n, h, w, c)).astype(
        np.float32)


# -- D2 in evaluation ---------------------------------------------------------

def test_d2_module_matches_jax():
    """The module D2 in evaluation against D.apply(train=False), f32, with
    the same layer tree and parameter count."""
    dv = _d_variables(0)
    x = _images(1, 6)
    ref, _ = M.create_D(DIMS).apply(dv, jnp.asarray(x), train=False)
    D = bridge.load_jax_variables(zoo.create_D(DIMS), dv)
    with torch.no_grad():
        out = D(T(x))
    assert out.shape == (6, 1) and not D.training
    assert 0.05 < np.asarray(ref).min() < np.asarray(ref).max() < 0.95
    _close(out, ref, 1e-4)
    assert sum(p.numel() for p in D.parameters()) == \
        M.count_parameters(dv["params"])
    assert D.l0.l1.alpha.shape == (1,) and D.l3.b1.l0.l1.alpha.shape == (1,)
    with pytest.raises(ValueError):
        zoo.create_D(DIMS, init="lecun")
    with pytest.raises(ValueError):
        zoo.create_D((3, 12, 12))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_fast_discriminator_matches_jax(dtype, tol):
    """make_fast_discriminator (B6's plain version on the CPU) against the
    JAX D2 in evaluation in the same compute dtype; 5 layers on B6, no
    launch on the CPU."""
    dv = _d_variables(2)
    x = _images(3, 7)
    ref, _ = M.create_D(DIMS, dtype=getattr(jnp, dtype)).apply(
        dv, jnp.asarray(x), train=False)
    rate = fastpath.make_fast_discriminator(DIMS, getattr(torch, dtype))
    before = conv_kernel.conv3x3_bn_act.launches
    with torch.no_grad():
        out = rate(bridge.to_torch(dv, "cpu"), T(x))
    assert conv_kernel.conv3x3_bn_act.launches == before
    assert out.dtype == getattr(torch, dtype) and out.shape == (7, 1)
    _close(out.float(), np.asarray(ref.astype(jnp.float32)), tol)


def test_fast_discriminator_takes_module_tensors():
    D = modules.init_parameters(zoo.create_D((1, 8, 8)),
                                torch.Generator().manual_seed(0))
    x = torch.rand(3, 8, 8, 1)
    with torch.no_grad():
        out = fastpath.make_fast_discriminator((1, 8, 8), torch.float32)(
            bridge.module_variables(D), x)
        assert torch.allclose(out, D(x), atol=1e-6)
    with pytest.raises(ValueError):
        fastpath.make_fast_discriminator((1, 12, 12))


# -- D2 in training -----------------------------------------------------------

def test_d2_training_without_dropout_matches_jax():
    """train=True with every dropout at rate 0: the output and the BCE
    gradients w.r.t. the parameters and the input, f32."""
    dv = _d_variables(4, amplify=1.0)
    x = _images(5, 6)
    t = np.array([1, 0, 1, 0, 0, 1], np.float32)
    jd = _no_dropout(M.create_D(DIMS))

    def loss_fn(p, xx):
        out, _ = jd.apply({"params": p, "state": {}}, xx, train=True,
                          rng=jax.random.PRNGKey(0))
        return JT.bce(out.reshape(-1), jnp.asarray(t)), out

    (ref_loss, ref_out), (ref_gp, ref_gx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(dv["params"], jnp.asarray(x))
    D = _port_no_dropout(bridge.load_jax_variables(zoo.create_D(DIMS),
                                                   dv)).train()
    tx = T(x).requires_grad_(True)
    out = D(tx)
    loss = bce(out.reshape(-1), T(t))
    names = [n for n, _ in D.named_parameters()]
    grads = torch.autograd.grad(loss, [tx] + list(D.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    _close(out.detach(), ref_out, 1e-5)
    _close(grads[0], ref_gx, 1e-4)
    for n, g in zip(names, grads[1:]):
        _close(g, bridge._lookup(ref_gp, n), 1e-4)


def test_spatial_dropout_drops_whole_maps():
    """SpatialDropout(0.25) in training: each (sample, channel) map is
    either all zero or scaled by 1 / 0.75, about three quarters kept (4,096
    maps: 0.75 +- 0.035 is five standard deviations); inside D2 every one
    of its five SpatialDropouts drops whole maps."""
    sd = modules.SpatialDropout(0.25).train()
    sd.generator = torch.Generator().manual_seed(0)
    y = sd(torch.ones(64, 3, 5, 64))
    maps = y[:, 0, 0, :]
    assert torch.equal(y, maps[:, None, None, :].expand_as(y))
    kept = maps != 0
    assert torch.equal(maps[kept], torch.full_like(maps[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.035
    D = modules.init_parameters(zoo.create_D(DIMS),
                                torch.Generator().manual_seed(1))
    modules.set_dropout_generator(D.train(), torch.Generator().manual_seed(2))
    seen = []
    hooks = [m.register_forward_hook(lambda mod, i, o: seen.append((i[0], o)))
             for m in D.modules() if isinstance(m, modules.SpatialDropout)]
    D(torch.rand(4, 16, 16, 3))
    for hk in hooks:
        hk.remove()
    assert len(seen) == 5
    for inp, o in seen:
        dropped = (o == 0).all(dim=(1, 2)) & (inp != 0).any(dim=(1, 2))
        live = ~(o == 0).all(dim=(1, 2))
        assert dropped.any()
        assert torch.allclose(o.permute(0, 3, 1, 2)[live],
                              inp.permute(0, 3, 1, 2)[live] / 0.75)


# -- the bridge ---------------------------------------------------------------

def test_bridge_d2_both_ways():
    dv = _d_variables(6)
    D = bridge.load_jax_variables(zoo.create_D(DIMS), dv)
    back = bridge.export_variables(D)
    assert back["state"] == {}
    jl = jax.tree_util.tree_leaves_with_path(dv["params"])
    pl_ = jax.tree_util.tree_leaves_with_path(back["params"])
    assert [p for p, _ in jl] == [p for p, _ in pl_]
    for (_, a), (_, b) in zip(jl, pl_):
        np.testing.assert_array_equal(a, b)
    assert set(back["params"]) == {"l0", "l1", "l3", "l4", "l5", "l7"}
    assert set(back["params"]["l3"]) == {"b0", "b1"}


def test_gan_tree_round_trip(tmp_path):
    """A JAX GanState (adam moments, int32 steps) and vis_noise_inputs,
    written by the JAX package, load into the port and come back leaf for
    leaf, dtypes included; the port's tree loads back into JAX."""
    c, h, w = DIMS
    gv, _ = M.create_G(DIMS, ND).init(jax.random.PRNGKey(0), (ND,))
    gs = JT.GanState(g=JT.TrainState.create(gv, O.adam()),
                     d=JT.TrainState.create(_d_variables(7), O.adam()))
    gs = dataclasses.replace(gs, d=dataclasses.replace(
        gs.d, step=jnp.asarray(5, jnp.int32)))
    vis = np.random.default_rng(0).normal(size=(100, ND)).astype(np.float32)
    path = str(tmp_path / "adversarial")
    gio.save_checkpoint(path, jcommon.gan_to_tree(
        gs, {"vis_noise_inputs": vis}))
    tree = ckpt.load_checkpoint(path)[0]
    pgs = common.gan_from_tree(tree, zoo.create_G(DIMS, ND),
                               zoo.create_D(DIMS), PO.adam(), PO.adam(), "cpu")
    assert (pgs.g.step, pgs.d.step) == (0, 5)
    back = common.gan_to_tree(pgs, {"vis_noise_inputs": torch.from_numpy(vis)})
    ref = jax.tree_util.tree_leaves_with_path(tree)
    out = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in ref] == [p for p, _ in out]
    for (_, a), (_, b) in zip(ref, out):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    ckpt.save_checkpoint(path, back)
    jgs = jcommon.gan_from_tree(gio.load_checkpoint(path)[0])
    assert int(jgs.d.step) == 5


# -- one batch pair against JAX -----------------------------------------------

def test_batch_pairs_match_jax():
    """f32, dropouts off, adam on both networks, the default penalties
    (D_L2 1e-4, D_clamp 1, G_clamp 5): a D step on a real half and a G
    step, the latents from JAX's own splits (k_noise, _, _ = split(key, 3);
    noise_inputs(k_noise, ...)). After pairs 1 to 3, each started from the
    JAX state: G and D parameters, G's BN running statistics, adam's
    moments, both losses and the confusion counts."""
    jg, jd = M.create_G(DIMS, ND), _no_dropout(M.create_D(DIMS))
    gv, _ = jg.init(jax.random.PRNGKey(1), (ND,))
    d_step_j, g_step_j = JT.make_adversarial_steps(
        jg, jd, batch_size=BATCH, noise_dim=ND, noise_method="normal")
    jgs = JT.GanState(g=JT.TrainState.create(gv, O.adam()),
                      d=JT.TrainState.create(_d_variables(8, amplify=2.0),
                                             O.adam()))
    d_step, g_step = adv.make_adversarial_steps(dtype=torch.float32)
    reals = _images(9, 3 * BATCH // 2).reshape(3, BATCH // 2, 16, 16, 3)
    leaves = jax.tree_util.tree_leaves
    for i in range(3):
        kd, kg = jax.random.PRNGKey(20 + i), jax.random.PRNGKey(40 + i)
        zd = np.asarray(j_noise(jax.random.split(kd, 3)[0], BATCH // 2, ND))
        zg = np.asarray(j_noise(jax.random.split(kg, 3)[0], BATCH, ND))
        tree = jax.tree_util.tree_map(np.asarray, jcommon.gan_to_tree(jgs))
        gs = common.gan_from_tree(tree, zoo.create_G(DIMS, ND),
                                  _port_no_dropout(zoo.create_D(DIMS)),
                                  PO.adam(), PO.adam(), "cpu")
        jgs, jconf, ref_dl = d_step_j(jgs, jnp.asarray(reals[i]),
                                      JT.Confusion.zero(), kd)
        jgs, ref_gl = g_step_j(jgs, kg)
        conf = adv.Confusion.zero()
        dl = d_step(gs, T(reals[i].copy()), T(zd.copy()), conf)
        gl = g_step(gs, T(zg.copy()))
        np.testing.assert_allclose(float(dl), float(ref_dl), rtol=1e-5)
        np.testing.assert_allclose(float(gl), float(ref_gl), rtol=1e-5)
        np.testing.assert_array_equal(conf.counts.numpy(),
                                      np.asarray(jconf.counts))
        out = common.gan_to_tree(gs)
        ref = jcommon.gan_to_tree(jgs)
        for net in ("G", "D"):
            n_off = n_all = 0
            for r, o in zip(leaves(ref[net]["params"]),
                            leaves(out[net]["params"])):
                diff = np.abs(np.asarray(o) - np.asarray(r))
                n_off += int((diff > 1e-5 * max(1.0, np.abs(r).max())).sum())
                n_all += diff.size
                assert diff.max() <= 2e-3 + 1e-6
            assert n_off < 0.05 * n_all, (net, i, n_off, n_all)
            for r, o in zip(leaves(ref[net]["state"]),
                            leaves(out[net]["state"])):
                _close(o, r, 1e-5)
            for k in ("m", "v"):
                for r, o in zip(leaves(ref[net]["opt_state"][k]),
                                leaves(out[net]["opt_state"][k])):
                    _close(o, r, 1e-5)
            assert int(out[net]["step"]) == int(ref[net]["step"]) == i + 1


# -- the epoch ----------------------------------------------------------------

def _port_gan(dims=(1, 8, 8), seed=0):
    gen = torch.Generator().manual_seed(seed)
    G = modules.init_parameters(zoo.create_G(dims, ND), gen)
    D = modules.init_parameters(zoo.create_D(dims), gen)
    modules.set_dropout_generator(D, torch.Generator().manual_seed(seed + 1))
    return GanState(g=TrainState.create(G, PO.adam()),
                    d=TrainState.create(D, PO.adam()))


def test_epoch_program_wraps_around():
    """tests/test_train.py's epoch check: d_iterations = g_iterations = 2
    on data smaller than the epoch needs; loss shapes, step counts, the
    confusion total, and G's parameters moved."""
    gs = _port_gan()
    g0 = [p.detach().clone() for p in gs.g.module.parameters()]
    n_batches, iters = 3, 2
    epoch = adv.make_epoch_program(
        batch_size=BATCH, noise_dim=ND, noise_method="normal",
        n_batches=n_batches, dtype=torch.float32, d_iterations=iters,
        g_iterations=iters)
    data = torch.rand(10, 8, 8, 1, generator=torch.Generator().manual_seed(3))
    conf = adv.Confusion.zero()
    d_losses, g_losses = epoch(gs, conf, data,
                               torch.Generator().manual_seed(4))
    assert d_losses.shape == g_losses.shape == (n_batches * iters,)
    assert torch.isfinite(torch.cat([d_losses, g_losses])).all()
    assert gs.d.step == gs.g.step == n_batches * iters
    assert int(gs.d.opt_state["step"]) == n_batches * iters
    assert int(conf.counts.sum()) == n_batches * iters * BATCH
    assert conf.counts.dtype == torch.int32
    assert max((a - b).abs().max().item()
               for a, b in zip(g0, gs.g.module.parameters())) > 0


def test_real_halves_in_jax_order():
    """train_epoch consumes the real halves in the JAX train_epoch's order
    (its cursor, wrapping around), stops between batches on should_stop,
    and returns zero losses when stopped before the first batch."""
    data = np.arange(10, dtype=np.float32).reshape(10, 1, 1, 1)
    jseen, pseen = [], []

    def jd(gs, real, confusion, key):
        jseen.append(np.asarray(real).ravel())
        return gs, confusion, jnp.zeros(())

    def jgstep(gs, key):
        return gs, jnp.zeros(())

    JT.train_epoch(jd, jgstep, None, jnp.asarray(data), jax.random.PRNGKey(0),
                   batch_size=6, n_batches=3, d_iterations=2)

    def pd(gs, real, z, confusion):
        pseen.append(real.numpy().ravel())
        assert z.shape == (3, ND)
        return torch.zeros(())

    def pg(gs, z):
        assert z.shape == (6, ND)
        return torch.zeros(())

    def noise(n):
        return torch.zeros(n, ND)

    _, (dl, gl) = adv.train_epoch(pd, pg, None, T(data), noise, batch_size=6,
                                  n_batches=3, d_iterations=2)
    assert len(pseen) == len(jseen) == 6 and dl.shape == (6,)
    for a, b in zip(pseen, jseen):
        np.testing.assert_array_equal(a, b)
    calls = iter([False, True])
    _, (dl, gl) = adv.train_epoch(pd, pg, None, T(data), noise, batch_size=6,
                                  n_batches=3, should_stop=lambda: next(calls))
    assert dl.shape == gl.shape == (1,)
    _, (dl, gl) = adv.train_epoch(pd, pg, None, T(data), noise, batch_size=6,
                                  n_batches=3, should_stop=lambda: True)
    assert dl.tolist() == gl.tolist() == [0.0]


def test_confusion_matches_jax(rng):
    """add_batch counts (output > 0.5) against the targets as JAX does;
    render() is the JAX text for the same counts, character for
    character; the labels are JAX's."""
    outs = rng.uniform(size=40).astype(np.float32)
    outs[:3] = 0.5
    tgts = (rng.uniform(size=40) > 0.4).astype(np.float32)
    ref = JT.Confusion.zero().add_batch(jnp.asarray(outs), jnp.asarray(tgts))
    ref = ref.add_batch(jnp.asarray(outs[:7]), jnp.asarray(tgts[:7]))
    conf = adv.Confusion.zero().add_batch(T(outs), T(tgts))
    conf.add_batch(T(outs[:7]), T(tgts[:7]))
    np.testing.assert_array_equal(conf.counts.numpy(), np.asarray(ref.counts))
    assert conf.render() == ref.render()
    assert float(conf.total_valid) == float(ref.total_valid)
    assert adv.Confusion.zero().render() == JT.Confusion.zero().render()
    assert (adv.Y_GENERATOR, adv.Y_NOT_GENERATOR) == (
        JT.Y_GENERATOR, JT.Y_NOT_GENERATOR)
