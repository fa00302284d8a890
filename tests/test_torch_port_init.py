"""The port's weight init (``models/init.py``, ``modules.init_parameters``),
its remaining zoo models, ``train --init`` and ``--profile_dir``, the
forward golden, and ``utils/{sampling,timing}``, against the JAX package on
the CPU.

The init schemes can match JAX only in distribution (``jax.random``
streams cannot be reproduced), so the draws are held to JAX's per-leaf
half-widths (``scheme_std`` of the leaf's scheme and fans, read off the
JAX module), their spread (leaves of at least 4,096 elements: std within
3 % of half-width / sqrt(3); the sample std of n uniforms has a relative
standard error of about sqrt(0.2 / n), 0.7 % at n = 4,096) and JAX's set of
zero biases; BatchNorm scales are ones, or in [0, 1) under ``torch``."""
import json
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import models as J
from ganreverser_tpu.core.prng import noise_inputs as j_noise, seed_key
from ganreverser_tpu.models import init as j_init
from ganreverser_tpu.models import modules as jm
from ganreverser_tpu.utils import sampling as j_sampling
from ganreverser_tpu.utils import timing as j_timing
from ganreverser_tpu_torch.analysis import cosine_topk
from ganreverser_tpu_torch.cli import train
from ganreverser_tpu_torch.core.prng import INIT_STAGE, stage_generator
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.models import bridge, init, modules, zoo
from ganreverser_tpu_torch.utils import sampling, timing

from torch_port_fixtures import one_thread  # noqa: F401

INITS = ["heuristic", "torch", "xavier", "xavier_caffe", "kaiming"]
ND = 8
D3 = (3, 16, 16)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "forward_golden.npz")


@pytest.mark.parametrize("scheme", init.SCHEMES)
def test_scheme_std_is_jaxs(scheme):
    fans = [1, 3, 7, 27, 64, 100, 576, 1152, 4608, 32768]
    for fi in fans:
        for fo in fans:
            assert init.scheme_std(scheme, fi, fo) == \
                j_init.scheme_std(scheme, fi, fo)
    with pytest.raises(ValueError):
        init.scheme_std("lecun", 3, 3)
    with pytest.raises(ValueError):
        modules.Dense(3, 3, init_scheme="lecun")


# (JAX builder, port builder, JAX input shape) per model; dims (3,16,16),
# G4 at its only geometry 32x32
MODELS = {
    "G3": (lambda i: J.create_G3(D3, ND, init=i),
           lambda i: zoo.create_G3(D3, ND, init=i), (ND,)),
    "G4": (lambda i: J.create_G4((3, 32, 32), ND, init=i),
           lambda i: zoo.create_G4((3, 32, 32), ND, init=i), (ND,)),
    "G_encoder": (lambda i: J.create_G_encoder(D3, ND, init=i),
                  lambda i: zoo.create_G_encoder(D3, ND, init=i),
                  (16, 16, 3)),
    "D2": (lambda i: J.create_D2(D3, init=i),
           lambda i: zoo.create_D2(D3, init=i), (16, 16, 3)),
    "D_default": (lambda i: J.create_D_default(D3, init=i),
                  lambda i: zoo.create_D_default(D3, init=i), (16, 16, 3)),
    "D_facegen": (lambda i: J.create_D_facegen(D3, init=i),
                  lambda i: zoo.create_D_facegen(D3, init=i), (16, 16, 3)),
    "R": (lambda i: J.create_R(D3, ND, "uniform", init=i),
          lambda i: zoo.create_R(D3, ND, "uniform", init=i), (16, 16, 3)),
    "fixer_R": (lambda i: J.create_R(D3, ND, "normal", fixer=True, init=i),
                lambda i: zoo.create_R(D3, ND, "normal", fixer=True,
                                       init=i), (16, 16, 3)),
}
# createResidual has no init argument: its variants stand for its cases
RESIDUALS = {"heuristic": (8, 4, 6, "ReLU", True),
             "torch": (6, 6, 6, "PReLU", True),
             "xavier": (4, 8, 8, "LeakyReLU", False),
             "xavier_caffe": (8, 8, 4, "ReLU", True),
             "kaiming": (5, 5, 7, "PReLU", False)}


def _specs(module, prefix=""):
    """{param path: (kind, scheme, zero_bias | scale_init)} of a JAX
    module tree, keyed as its variables are."""
    out = {}
    if isinstance(module, jm.Sequential):
        for i, m in enumerate(module.layers):
            out.update(_specs(m, f"{prefix}l{i}."))
    elif isinstance(module, jm.ConcatBranches):
        for i, b in enumerate(module.branches):
            out.update(_specs(b, f"{prefix}b{i}."))
    elif isinstance(module, jm.Residual):
        out.update(_specs(module.inner, f"{prefix}inner."))
        out.update(_specs(module.shortcut, f"{prefix}shortcut."))
    elif isinstance(module, (jm.Dense, jm.Conv)):
        out[prefix[:-1]] = ("layer", module.init_scheme,
                            module.init_zero_bias)
    elif isinstance(module, jm.UpsampleConv):
        out[prefix[:-1]] = ("layer", module.init_scheme, True)
    elif isinstance(module, jm.BatchNorm):
        out[prefix[:-1]] = ("bn", None, module.scale_init)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _fans(kernel):
    """(fan_in, fan_out) of a dense (in, out) or HWIO conv kernel."""
    if kernel.ndim == 2:
        return kernel.shape
    k, _, ci, co = kernel.shape
    return ci * k * k, co * k * k


def _half_width(scheme, kernel):
    return j_init.scheme_std(scheme, *_fans(kernel))


def _check_draws(specs, params, state):
    """Every drawn leaf within its half-width and of the uniform's spread,
    the BatchNorm leaves as set; returns the paths of zero biases."""
    zero_biases = set()
    for path, (kind, scheme, how) in specs.items():
        if kind == "bn":
            scale = params[f"{path}.scale"]
            if how == "torch":
                assert 0.0 <= scale.min() and scale.max() < 1.0, path
                assert scale.std() > 0.1, path
            else:
                assert (scale == 1.0).all(), path
            assert (params[f"{path}.bias"] == 0).all()
            assert (state[f"{path}.mean"] == 0).all()
            assert (state[f"{path}.var"] == 1).all()
            continue
        kernel, bias = params[f"{path}.kernel"], params[f"{path}.bias"]
        hw = _half_width(scheme, kernel)
        assert np.abs(kernel).max() <= hw * (1 + 1e-6), path
        if kernel.size >= 4096:
            assert abs(kernel.std() / (hw / math.sqrt(3)) - 1) < 0.03, path
        if (bias == 0).all():
            zero_biases.add(path)
        else:
            assert np.abs(bias).max() <= hw * (1 + 1e-6), path
            assert (bias != 0).all(), path
    return zero_biases


def _model_case(model, scheme):
    if model == "residual":
        args = RESIDUALS[scheme]
        return (J.create_residual(*args), zoo.create_residual(*args),
                (8, 8, args[0]))
    j_build, p_build, shape = MODELS[model]
    return j_build(scheme), p_build(scheme), shape


@pytest.mark.parametrize("scheme", INITS)
@pytest.mark.parametrize("model", list(MODELS) + ["residual"])
def test_init_draws_hold_to_jax(model, scheme):
    """The port's parameter and state paths and shapes equal JAX's init's;
    both packages' draws keep to JAX's half-widths and spreads; the port's
    zero biases are JAX's; BatchNorm scales as JAX's scale_init says."""
    j_model, p_model, shape = _model_case(model, scheme)
    jv, _ = j_model.init(jax.random.PRNGKey(3), shape)
    gen = torch.Generator().manual_seed(4)
    ours = bridge.export_variables(modules.init_parameters(p_model, gen))
    j_params, j_state = _flat(jv["params"]), _flat(jv["state"])
    params, state = _flat(ours["params"]), _flat(ours["state"])
    assert {k: v.shape for k, v in params.items()} == \
        {k: v.shape for k, v in j_params.items()}
    assert {k: v.shape for k, v in state.items()} == \
        {k: v.shape for k, v in j_state.items()}
    assert modules.count_parameters(p_model) == J.count_parameters(
        jv["params"]) == modules.count_parameters(ours["params"])
    assert modules.count_weight_parameters(p_model) == \
        J.count_weight_parameters(jv["params"])
    specs = _specs(j_model)
    assert _check_draws(specs, params, state) == \
        _check_draws(specs, j_params, j_state)
    if scheme == "torch" and model in ("G4", "D2"):
        # nested layers keep torch's uniform biases
        assert len(specs) > len(_check_draws(specs, params, state))


def test_init_draws_on_the_generators_device_and_keep_heuristic_stream():
    """The default 'heuristic' draws each kernel from the generator and
    nothing else (the stream the port's checkpoints were drawn with), and
    a drawn bias follows its kernel from the same generator."""
    gen = torch.Generator().manual_seed(9)
    G = modules.init_parameters(zoo.create_G3((1, 8, 8), ND), gen)
    ref = torch.Generator().manual_seed(9)
    for m in G.modules():
        if isinstance(m, (modules.Dense, modules.Conv)):
            std = init.scheme_std("heuristic", *_fans(m.kernel))
            want = torch.empty_like(m.kernel).uniform_(-std, std,
                                                       generator=ref)
            torch.testing.assert_close(m.kernel.data, want, rtol=0, atol=0)
    k, b = torch.empty(4, 6), torch.empty(6)
    init.init_dense(k, b, torch.Generator().manual_seed(2), "xavier",
                    zero_bias=False)
    ref = torch.Generator().manual_seed(2)
    std = init.scheme_std("xavier", 4, 6)
    torch.testing.assert_close(k, torch.empty(4, 6).uniform_(
        -std, std, generator=ref), rtol=0, atol=0)
    torch.testing.assert_close(b, torch.empty(6).uniform_(
        -std, std, generator=ref), rtol=0, atol=0)


def test_forward_golden():
    """tests/goldens/forward_golden.npz through the port: G and R on the
    JAX init of tests/test_goldens.py carried by models/bridge.py give its
    images and zhat within that test's tolerances, and the port's cosine
    top-k its indices (and scores, rtol 1e-5)."""
    g = np.load(GOLDEN)
    key = seed_key(1234)
    gv, _ = J.create_G((1, 16, 16), 8).init(jax.random.fold_in(key, 1), (8,))
    rv, _ = J.create_R((1, 16, 16), 8, "normal").init(
        jax.random.fold_in(key, 2), (16, 16, 1))
    z = np.array(j_noise(jax.random.fold_in(key, 3), 16, 8, "normal"))
    np.testing.assert_allclose(z, g["z"], rtol=1e-6)
    G = bridge.load_jax_variables(zoo.create_G((1, 16, 16), 8),
                                  jax.tree.map(np.asarray, gv))
    R = bridge.load_jax_variables(zoo.create_R((1, 16, 16), 8, "normal"),
                                  jax.tree.map(np.asarray, rv))
    with torch.no_grad():
        images = G(torch.from_numpy(z)).numpy()
        zhat = R(torch.from_numpy(g["images"])).numpy()
    np.testing.assert_allclose(images, g["images"], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(zhat, g["zhat"], rtol=2e-5, atol=2e-5)
    sv, si = cosine_topk(torch.from_numpy(g["emb"]),
                         torch.tensor([0, 5, 9]), 10)
    np.testing.assert_array_equal(si.numpy(), g["topk_idx"])
    np.testing.assert_allclose(sv.numpy(), g["topk_scores"], rtol=1e-5,
                               atol=1e-6)


GEOM = ["--dataset", "synthetic", "--colorSpace", "y", "--height", "8",
        "--width", "8", "--noiseDim", str(ND), "--batchSize", "8",
        "--N_epoch", "2", "--noplot"]


@pytest.mark.parametrize("scheme", INITS)
def test_train_init_is_accepted_and_draws_by_scheme(scheme, tmp_path):
    """train --init <scheme> --epochs 0 saves fresh G and D drawn by that
    scheme: the zoo's models with ``init=scheme``, G's draws then D's from
    the init stage of --seed."""
    save = str(tmp_path / "logs")
    out = train.main(GEOM + ["--save", save, "--epochs", "0", "--init",
                             scheme, "--nopretraining"])
    tree, cfg, extra = ckpt.load_checkpoint(out["checkpoint"])
    assert cfg["init"] == scheme and extra["epoch"] == 0
    gen = stage_generator(1, INIT_STAGE, "cpu")
    for name, model in (("G", zoo.create_G((1, 8, 8), ND, init=scheme)),
                        ("D", zoo.create_D((1, 8, 8), init=scheme))):
        want = _flat(bridge.export_variables(
            modules.init_parameters(model, gen))["params"])
        got = _flat(tree[name]["params"])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    nested_bias = np.asarray(tree["D"]["params"]["l0"]["l0"]["bias"])
    assert (nested_bias != 0).all() == (scheme == "torch")


def test_train_profile_dir_writes_a_trace(tmp_path):
    """--profile_dir traces epoch 2 (as the JAX trainer does): one Chrome
    trace JSON whose events include the epoch's operators."""
    prof = tmp_path / "prof"
    train.main(GEOM + ["--save", str(tmp_path / "logs"), "--epochs", "2",
                       "--profile_dir", str(prof)])
    traces = sorted(prof.iterdir())
    assert len(traces) == 1 and traces[0].suffix == ".json"
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def _g3_pair(dims, seed):
    jv, _ = J.create_G3(dims, ND).init(jax.random.PRNGKey(seed), (ND,))
    jv = jax.tree.map(np.asarray, jv)
    return jv, bridge.load_jax_variables(zoo.create_G3(dims, ND), jv)


def test_sampling_matches_jax():
    """create_images_from_noise (the fast G, its plain versions on the
    CPU) and sort_images_by_prediction (the fast D) against JAX's on the
    same weights and noise, f32 (1e-5); the same order; to_batch and
    to_image_tensor the same arrays."""
    dims = (3, 16, 16)
    jg, G = _g3_pair(dims, 5)
    z = np.random.default_rng(0).normal(size=(40, ND)).astype(np.float32)
    theirs = np.asarray(j_sampling.create_images_from_noise(
        J.create_G3(dims, ND), jax.tree.map(jnp.asarray, jg),
        jnp.asarray(z), batch_size=16))
    ours = sampling.create_images_from_noise(
        G, bridge.module_variables(G), torch.from_numpy(z), batch_size=16)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-5)

    jd, _ = J.create_D2(dims).init(jax.random.PRNGKey(6), (16, 16, 3))
    jd = jax.tree.map(np.asarray, jd)
    for leaf in ("l4", "l7"):  # spread D's scores off 0.5
        jd["params"][leaf]["kernel"] = jd["params"][leaf]["kernel"] * 8
    D = bridge.load_jax_variables(zoo.create_D2(dims), jd)
    images = np.random.default_rng(1).uniform(size=(40, 16, 16, 3)).astype(
        np.float32)
    j_imgs, j_preds = j_sampling.sort_images_by_prediction(
        J.create_D2(dims), jax.tree.map(jnp.asarray, jd),
        jnp.asarray(images), nb_max_out=25, batch_size=16)
    imgs, preds = sampling.sort_images_by_prediction(
        D, bridge.module_variables(D), torch.from_numpy(images),
        nb_max_out=25, batch_size=16)
    np.testing.assert_allclose(preds.numpy(), np.asarray(j_preds),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(imgs.numpy(), np.asarray(j_imgs))
    _, asc = sampling.sort_images_by_prediction(
        D, bridge.module_variables(D), torch.from_numpy(images),
        ascending=True)
    assert (np.diff(asc.numpy()) >= 0).all() and np.ptp(asc.numpy()) > 1e-3

    gen = torch.Generator().manual_seed(3)
    made = sampling.create_images(G, bridge.module_variables(G), 7,
                                  noise_dim=ND, noise_method="uniform",
                                  generator=gen)
    assert made.shape == (7, 16, 16, 3)
    im = np.zeros((4, 4))
    for fn in ("to_batch",):
        np.testing.assert_array_equal(getattr(sampling, fn)(im),
                                      getattr(j_sampling, fn)(im))
    for arg, force in (([im, im], True), (np.zeros((2, 4, 4, 3)), False)):
        np.testing.assert_array_equal(
            sampling.to_image_tensor(arg, force),
            j_sampling.to_image_tensor(arg, force))


def test_timing_matches_jax():
    """time_best of a call that takes 20 ms (a sleep, returning a tensor
    or a JAX array): both packages near 20 ms; the port's time_amortized
    too (JAX's runs its function inside one compiled loop, where a sleep
    happens only while tracing); force accepts trees and waits for
    nothing on the CPU."""
    def port_fn(x):
        time.sleep(0.02)
        return {"y": [x + 1]}

    def jax_fn(x):
        time.sleep(0.02)
        return x + 1

    x = torch.zeros(3)
    timing.force({"a": (x, 1)})
    timing.force([])
    ours = timing.time_best(port_fn, x, repeats=2)
    theirs = j_timing.time_best(jax_fn, jnp.zeros(3), repeats=2)
    assert 0.02 <= ours < 0.2 and 0.02 <= theirs < 0.2
    assert 0.02 <= timing.time_amortized(port_fn, x, iters=3,
                                         repeats=1) < 0.2
