"""The rest of apply_r against the JAX package: the fixer-R (its always-on
dropout, its checkpoint, the fast fixer on kernel B's plain version), the
variation sweep, fixing, the anomaly scores and threshold, latent
refinement, the metrics log, and the port's CLI against the JAX CLI on the
same JAX-written checkpoints. f32 at small geometry; tolerances 1e-4 (f32
sums in another order) unless stated."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganreverser_tpu import analysis as A
from ganreverser_tpu import io as gio
from ganreverser_tpu import models as M
from ganreverser_tpu.cli import apply_r as j_apply_r
from ganreverser_tpu.core.prng import noise_inputs as j_noise_inputs
from ganreverser_tpu.io.metrics import MetricsWriter as JMetricsWriter
from ganreverser_tpu_torch import parallel as par
from ganreverser_tpu_torch.analysis import distributed, e2e
from ganreverser_tpu_torch.analysis import pipeline as P
from ganreverser_tpu_torch.analysis.refine import make_refiner
from ganreverser_tpu_torch.cli import apply_r, pretrain_prev, sample
from ganreverser_tpu_torch.core import prng
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.io.metrics import MetricsWriter
from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
from ganreverser_tpu_torch.ops import (conv_block_kernel, kmeans_kernel,
                                       topk_kernel, upsample_conv_kernel)
from ganreverser_tpu_torch.utils import sampling

from torch_port_fixtures import one_thread  # noqa: F401

T = torch.from_numpy
DIMS, ND = (3, 16, 16), 8


def _variables(model, in_shape, seed, rng, amplify=1.0):
    """JAX variables with non-trivial BN stats; ``amplify`` scales the
    kernels so that random-init images and latents are not near-constant."""
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


def _shift_layers(tree):
    """Plain-R variables relabelled as the fixer's (l<i> -> l<i+1>)."""
    return {part: {f"l{int(k[1:]) + 1}": v for k, v in tree[part].items()}
            for part in ("params", "state")}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_always_on_dropout_draws_from_its_generator():
    x = torch.rand(4, 6, 6, 3)
    drop = modules.Dropout(0.5, always_on=True)
    with pytest.raises(ValueError):
        drop(x)
    drop.generator = _gen(3)
    y = drop(x)
    keep = modules.dropout_keep_mask(x.shape, 0.5, _gen(3), "cpu")
    np.testing.assert_array_equal(y.numpy(),
                                  torch.where(keep, x * 2, 0.0).numpy())
    assert 0.3 < keep.float().mean().item() < 0.7
    assert not torch.equal(drop(x), y)  # a fresh mask on every call
    drop.generator = _gen(3)
    yb = drop(x.to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        yb.float().numpy(),
        torch.where(keep, x.to(torch.bfloat16).float() * 2, 0.0).numpy())
    # the other dropouts stay the identity in evaluation; in training they
    # draw from their generator too, and raise without one
    for m in (modules.Dropout(0.5).eval(),
              modules.SpatialDropout(0.25).eval()):
        assert torch.equal(m(x), x)
        with pytest.raises(ValueError):
            m.train()(x)
        m.generator = _gen(3)
        assert not torch.equal(m(x), x)


def test_fixer_checkpoint_from_jax_loads_into_port(tmp_path, rng):
    """A fixer-R checkpoint as ``train_r --fixer`` writes it (the JAX
    create_R(fixer=True) tree under "R") loads through the bridge: the
    dropout is l0 and every layer index is one past the plain R's."""
    c, h, w = DIMS
    jrf = M.create_R(DIMS, ND, "normal", fixer=True)
    v = _variables(jrf, (h, w, c), 3, rng)
    path = gio.r_name(str(tmp_path), c, h, w, ND, "normal", True)
    gio.save_checkpoint(path, {"R": v}, config={"noiseDim": ND})
    tree, _, _ = ckpt.load_checkpoint(path)
    port = bridge.load_jax_variables(
        zoo.create_R(DIMS, ND, "normal", fixer=True), tree["R"])
    assert isinstance(port.l0, modules.Dropout) and port.l0.always_on
    assert isinstance(port.l1, modules.Conv)
    np.testing.assert_array_equal(port.l1.kernel.detach().numpy(),
                                  v["params"]["l1"]["kernel"])
    np.testing.assert_array_equal(port.l29.mean.numpy(),
                                  v["state"]["l29"]["mean"])
    with pytest.raises(KeyError):  # the plain R has a conv at l0
        bridge.load_jax_variables(zoo.create_R(DIMS, ND, "normal"),
                                  tree["R"])


@pytest.mark.parametrize("noise_method", ["normal", "uniform"])
def test_fast_fixer_matches_jax_r_on_masked_input(rng, noise_method):
    """The fast fixer with the mask of generator seed 5 == JAX's plain R on
    x * m / 0.5 with the same weights relabelled, and == the port's module
    fixer-R whose dropout draws from a generator of the same seed."""
    c, h, w = DIMS
    jr = M.create_R(DIMS, ND, noise_method)
    rv = _variables(jr, (h, w, c), 4, rng, amplify=2.0)
    rfv = _shift_layers(rv)
    x = rng.uniform(size=(6, h, w, c)).astype(np.float32)
    keep = modules.dropout_keep_mask(x.shape, 0.5, _gen(5), "cpu").numpy()
    ref = np.asarray(jr.apply(rv, jnp.asarray(np.where(keep, x / 0.5, 0.0)),
                              train=False)[0])
    fix = fastpath.make_fast_fixer(DIMS, ND, noise_method, torch.float32)
    out = fix(bridge.to_torch(rfv, "cpu"), T(x), _gen(5))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    module = bridge.load_jax_variables(
        zoo.create_R(DIMS, ND, noise_method, fixer=True), rfv)
    module.l0.generator = _gen(5)
    with torch.no_grad():
        np.testing.assert_allclose(module(T(x)).numpy(), out.numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("noise_method", ["normal", "uniform"])
def test_variation_sweep_matches_jax(rng, noise_method):
    G = M.create_G(DIMS, ND)
    gv = _variables(G, (ND,), 5, rng, amplify=2.0)
    key = jax.random.PRNGKey(11)
    base = np.array(j_noise_inputs(key, 1, ND, noise_method)[0])
    ref = np.asarray(A.variation_sweep(G, gv, noise_dim=ND,
                                       noise_method=noise_method, key=key,
                                       nb_steps=16, batch_size=32))
    out = P.variation_sweep(bridge.to_torch(gv, "cpu"), dims=DIMS,
                            noise_dim=ND, noise_method=noise_method,
                            base=T(base), nb_steps=16, batch_size=32)
    assert out.shape == ref.shape == (ND * 16, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    noise = P.variation_noise(T(base), noise_method, 16).numpy()
    lo, hi = (-1.0, 1.0) if noise_method == "uniform" else (-3.0, 3.0)
    np.testing.assert_allclose(noise[5 * 16:6 * 16, 5],
                               np.linspace(lo, hi, 16), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.delete(noise[5 * 16 + 3], 5),
                                  np.delete(base, 5))


def test_fixing_and_anomaly_scores_match_jax(rng):
    G = M.create_G(DIMS, ND)
    gv = _variables(G, (ND,), 6, rng, amplify=2.0)
    z = rng.normal(size=(40, ND)).astype(np.float32)
    ref_fixed = np.array(A.fix_images(G, gv, jnp.asarray(z), batch_size=16))
    fixed = P.fix_images(bridge.to_torch(gv, "cpu"), T(z), dims=DIMS,
                         noise_dim=ND, batch_size=16)
    np.testing.assert_allclose(fixed.numpy(), ref_fixed, rtol=1e-4,
                               atol=1e-4)
    images = rng.uniform(size=ref_fixed.shape).astype(np.float32)
    ref_scores, ref_thr, ref_flags = A.detect_anomalies(
        jnp.asarray(images), jnp.asarray(ref_fixed), 0.15)
    scores, thr, flags = P.detect_anomalies(T(images), T(ref_fixed), 0.15)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores),
                               rtol=1e-5, atol=1e-5)
    # on the same scores the index rule and the flags agree exactly
    js = np.array(ref_scores)
    assert P.anomaly_threshold(T(js), 0.15).item() == float(ref_thr)
    np.testing.assert_array_equal(T(js).le(float(ref_thr)).numpy(),
                                  np.asarray(ref_flags))
    assert flags.sum().item() == int(40 * 0.15)


@pytest.mark.parametrize("n,q", [(1024, 0.15), (100, 0.15), (5, 0.1),
                                 (7, 0.5)])
def test_anomaly_threshold_index_rule(rng, n, q):
    """Element max(int(n q) - 1, 0) of the ascending sort, flags score <=
    threshold: 153 of 1024 at the default 15 %, as the JAX package."""
    scores = rng.permutation(n).astype(np.float32) / n
    thr = P.anomaly_threshold(T(scores), q).item()
    assert thr == float(A.anomaly_threshold(jnp.asarray(scores), q))
    assert thr == np.sort(scores)[max(int(n * q) - 1, 0)]
    assert int((T(scores) <= thr).sum()) == max(int(n * q), 1)


def test_refine_matches_jax(rng):
    """5 adam steps through the frozen G, f32: z and the final per-image
    loss against the JAX refiner, and the chunked refiner against one
    chunk."""
    dims, nd = (1, 8, 8), 6
    G = M.create_G(dims, nd)
    gv = _variables(G, (nd,), 7, rng, amplify=2.0)
    z_true = rng.normal(size=(8, nd)).astype(np.float32)
    images = np.array(G.apply(gv, jnp.asarray(z_true), train=False)[0])
    z0 = (z_true + rng.normal(size=z_true.shape)).astype(np.float32)
    ref_z, ref_loss = A.make_refiner(G, steps=5, lr=0.05)(gv, images, z0)
    tg = bridge.load_jax_variables(zoo.create_G3(dims, nd), gv)
    z, loss = make_refiner(tg, steps=5, lr=0.05)(T(images), T(z0))
    assert z.dtype == loss.dtype == torch.float32 and loss.shape == (8,)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss),
                               rtol=1e-4, atol=1e-6)
    zc, lc = make_refiner(tg, steps=5, lr=0.05, batch_size=3)(T(images),
                                                               T(z0))
    np.testing.assert_allclose(zc.numpy(), z.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lc.numpy(), loss.numpy(), rtol=1e-5,
                               atol=1e-7)
    assert not any(p.requires_grad for p in tg.parameters())


def test_metrics_records_match_jax(tmp_path):
    for writer_cls, sub in ((MetricsWriter, "port"), (JMetricsWriter, "jax")):
        writer = writer_cls(str(tmp_path / sub), name="stats")
        writer.scalar("n_inverted", 300)
        writer.scalar("cluster_size", 7, step=2)
        writer.close()
    recs = {sub: [json.loads(line) for line in
                  open(tmp_path / sub / "stats.jsonl")]
            for sub in ("port", "jax")}
    for a, b in zip(recs["port"], recs["jax"]):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k != "wall"} == \
            {k: v for k, v in b.items() if k != "wall"}


def test_stage_generators():
    """Stage ② keeps --seed itself; every stage has a stream of its own."""
    assert prng.stage_seed(1, 2) == 1
    seeds = {prng.stage_seed(1, s) for s in (1, 2, 3, 5)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 64 for s in seeds)
    a = torch.rand(3, generator=prng.stage_generator(1, 2, "cpu"))
    b = torch.rand(3, generator=prng.seeded_generator(1, "cpu"))
    assert torch.equal(a, b)


def _write_checkpoints(save, rng, dims, nd, fixer):
    c, h, w = dims
    cfg = {"noiseDim": nd, "noiseMethod": "normal", "colorSpace": "y",
           "height": h, "width": w}
    G = M.create_G(dims, nd)
    gio.save_checkpoint(gio.adversarial_name(save),
                        {"G": _variables(G, (nd,), 8, rng, amplify=4.0),
                         "D": {}}, config=cfg)
    for is_fixer in (False, True) if fixer else (False,):
        R = M.create_R(dims, nd, "normal", fixer=is_fixer)
        gio.save_checkpoint(gio.r_name(save, c, h, w, nd, "normal", is_fixer),
                            {"R": _variables(R, (h, w, c), 9, rng,
                                             amplify=4.0)}, config=cfg)


ARGS = ["--N", "300", "--needles", "2", "--batchSize", "64", "--clusters",
        "3", "--kmeans_iters", "3", "--anomalies_n", "128"]


def _stats(out):
    return [json.loads(line) for line in
            open(os.path.join(out, "apply_r_stats.jsonl"))]


def test_apply_r_matches_jax_cli(tmp_path, rng, capsys):
    """The port's CLI and the JAX CLI on the same JAX-written G, R and
    fixer-R write the same artifacts and the same stats keys."""
    save = str(tmp_path / "logs")
    _write_checkpoints(save, rng, (1, 8, 8), 6, fixer=True)
    g = os.path.join(save, "adversarial")
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "port")
    j_apply_r.main(["--G", g, "--save", save, "--writeto", j_out, *ARGS])
    capsys.readouterr()
    result = apply_r.main(["--G", g, "--save", save, "--writeto", t_out,
                           *ARGS])
    printed = capsys.readouterr().out
    assert "not ported yet" not in printed and "no fixer" not in printed
    for stage in "①②③④⑤⑥":
        assert f"stage {stage}" in printed

    def files(d):
        return {f for f in os.listdir(d) if not f.startswith("cluster_")}
    assert files(t_out) == files(j_out)
    assert {"variations.jpg", "anomalies.jpg", "fixed_pairs.jpg",
            "fixed_images_528.jpg", "fixed_images_528_unfixed.jpg",
            "similar_pixelwise_02.jpg",
            "apply_r_stats.jsonl"} <= files(t_out)
    stats, j_stats = _stats(t_out), _stats(j_out)
    assert [(r["tag"], r.get("step")) for r in stats] == \
        [(r["tag"], r.get("step")) for r in j_stats]
    by_tag = {}
    for r in stats:
        by_tag.setdefault(r["tag"], []).append(r["value"])
    sizes = by_tag["cluster_size"]
    assert by_tag["n_inverted"] == [300.0] and sum(sizes) == 300
    for ci, size in enumerate(sizes):
        assert os.path.isfile(os.path.join(
            t_out, f"cluster_{ci + 1:02d}.jpg")) == (size > 0)
    assert by_tag["anomaly_count"] == [float(result["is_anomaly"].sum())]
    assert result["is_anomaly"].sum().item() == int(128 * 0.15)
    assert result["counts"].sum().item() == 300
    assert result["attributes_fixer"] is not result["attributes"]
    assert set(result["seconds"]) == {"variations", "generate_invert",
                                      "cluster", "search", "fix",
                                      "anomalies"}
    assert result["variations"].shape == (6 * 16, 8, 8, 1)
    assert (conv_block_kernel.conv_block.launches,
            upsample_conv_kernel.upsample2_conv3x3_bn_act.launches,
            topk_kernel.cosine_scores.launches,
            kmeans_kernel.kmeans_step.launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("fixer", [False, True])
def test_apply_r_refine_follows_alias_rule(tmp_path, rng, capsys, fixer):
    """--refine_steps > 0 refines the latents; without a fixer-R, fixing
    and anomalies follow the refined latents, with one they keep the
    fixer's."""
    save = str(tmp_path / "logs")
    _write_checkpoints(save, rng, (1, 8, 8), 6, fixer=fixer)
    result = apply_r.main(["--G", os.path.join(save, "adversarial"),
                           "--save", save, "--writeto",
                           str(tmp_path / "out"), *ARGS, "--refine_steps",
                           "2"])
    printed = capsys.readouterr().out
    assert "refine" in result["seconds"] and "final pixel MSE" in printed
    assert result["attributes"].dtype == torch.float32
    assert torch.isfinite(result["attributes"]).all()
    assert (result["attributes_fixer"] is result["attributes"]) != fixer
    assert ("no fixer checkpoint" in printed) != fixer


def test_apply_r_pallas_is_inert(tmp_path, rng, capsys):
    """apply_r --pallas (the JAX CLI's flag) is accepted, says in its help
    and on its output that it is inert, and changes no result."""
    from ganreverser_tpu_torch.core.config import ApplyConfig
    help_text = ApplyConfig.__dataclass_fields__["pallas"].metadata["help"]
    assert "inert" in help_text
    save = str(tmp_path / "logs")
    _write_checkpoints(save, rng, (1, 8, 8), 6, fixer=False)
    base = ["--G", os.path.join(save, "adversarial"), "--save", save,
            *ARGS]
    plain = apply_r.main([*base, "--writeto", str(tmp_path / "a")])
    assert "--pallas is inert" not in capsys.readouterr().out
    flagged = apply_r.main([*base, "--writeto", str(tmp_path / "b"),
                            "--pallas"])
    assert "--pallas is inert" in capsys.readouterr().out
    for key in ("images", "attributes", "counts", "is_anomaly"):
        assert torch.equal(plain[key], flagged[key]), key


class _CountingPrepare:
    """Wraps a fast-forward factory: every forward it makes counts its
    ``prepare`` calls in ``self.calls``."""

    def __init__(self, make):
        self.make, self.calls = make, 0

    def __call__(self, *args, **kwargs):
        f = self.make(*args, **kwargs)
        prepare = f.prepare

        def counted(variables):
            self.calls += 1
            return prepare(variables)
        f.prepare = counted
        return f


@pytest.mark.parametrize("int8", [False, True])
def test_pipeline_prepares_each_forward_once(monkeypatch, rng, int8):
    """② (G, R and the fixer-R), ① and ⑤ prepare each fast forward once
    per call, not once per chunk, and give bitwise what the per-chunk form
    (``f(variables, chunk)`` for every chunk) gives."""
    dims, nd, n, batch = (1, 8, 8), 4, 40, 16
    gv = bridge.to_torch(_variables(M.create_G(dims, nd), (nd,), 1, rng,
                                    amplify=4.0), "cpu")
    rv = bridge.to_torch(_variables(M.create_R(dims, nd, "normal"),
                                    (8, 8, 1), 2, rng, amplify=4.0), "cpu")
    rfv = bridge.to_torch(_shift_layers(_variables(
        M.create_R(dims, nd, "normal"), (8, 8, 1), 3, rng, amplify=4.0)),
        "cpu")
    names = (("make_fast_generator_int8", "make_fast_inverter_int8")
             if int8 else ("make_fast_generator", "make_fast_inverter"))
    counters = {name: _CountingPrepare(getattr(P, name))
                for name in (*names, "make_fast_generator", "make_fast_fixer")}
    for name, counter in counters.items():
        monkeypatch.setattr(P, name, counter)
    got = P.generate_and_invert(
        gv, rv, dims=dims, n=n, noise_dim=nd, noise_method="normal",
        generator=_gen(5), batch_size=batch, rf_variables=rfv,
        fixer_generator=_gen(6), int8=int8)
    assert {k: c.calls for k, c in counters.items()} == {
        **dict.fromkeys(counters, 0), **dict.fromkeys(names, 1),
        "make_fast_fixer": 1}
    noise, images = got[0], got[1]
    gen_f = (fastpath.make_fast_generator_int8 if int8
             else fastpath.make_fast_generator)(dims, nd, torch.float32)
    inv_f = (fastpath.make_fast_inverter_int8 if int8
             else fastpath.make_fast_inverter)(dims, nd, "normal",
                                               torch.float32)
    fix_f = fastpath.make_fast_fixer(dims, nd, "normal", torch.float32)
    per_chunk = P.forward_batched(lambda z: gen_f(gv, z), noise, batch)
    assert torch.equal(images, per_chunk)
    assert torch.equal(got[2], P.forward_batched(lambda x: inv_f(rv, x),
                                                 images, batch))
    g6 = _gen(6)
    assert torch.equal(got[3], P.forward_batched(
        lambda x: fix_f(rfv, x, g6), images, batch))
    if int8:
        return
    for c in counters.values():
        c.calls = 0
    sweep = P.variation_sweep(gv, dims=dims, noise_dim=nd,
                              noise_method="normal", base=noise[0],
                              batch_size=batch)
    fixed = P.fix_images(gv, got[2], dims=dims, noise_dim=nd,
                         batch_size=batch)
    assert counters["make_fast_generator"].calls == 2
    assert torch.equal(sweep, P.forward_batched(
        lambda z: gen_f(gv, z), P.variation_noise(noise[0], "normal"),
        batch))
    assert torch.equal(fixed, P.forward_batched(lambda z: gen_f(gv, z),
                                                got[2], batch))


# -- one fast G, prepared once per call ---------------------------------------

SMALL, SMALL_ND = (1, 8, 8), 8


def _port_nets(seed):
    """The port's G3, D2, R and fixer-R at SMALL, random weights from
    ``seed`` with their kernels x4 (so that images and latents vary)."""
    g = torch.Generator().manual_seed(seed)
    nets = {"G": zoo.create_G3(SMALL, SMALL_ND), "D": zoo.create_D(SMALL),
            "R": zoo.create_R(SMALL, SMALL_ND, "normal"),
            "RF": zoo.create_R(SMALL, SMALL_ND, "normal", fixer=True)}
    for m in nets.values():
        modules.init_parameters(m, g)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("kernel"):
                    p.mul_(4.0)
        m.eval()
    return nets


def _gd_checkpoint(path, nets):
    """``nets``' G and D as a port checkpoint at SMALL, as sample and
    pretrain_prev read it."""
    c, h, w = SMALL
    ckpt.save_checkpoint(path, {k: bridge.export_variables(nets[k])
                                for k in ("G", "D")},
                         config={"noiseDim": SMALL_ND, "noiseMethod": "normal",
                                 "colorSpace": "y", "height": h, "width": w})
    return path


def _pretrain_prev_args(prev, save):
    return ["--network", prev, "--dataset", "synthetic", "--save", save,
            "--N_batches", "3", "--batchSize", "8", "--noiseDim", "6",
            "--colorSpace", "y", "--height", "8", "--width", "8"]


@pytest.mark.parametrize("caller", [
    "variation_sweep", "generate_and_invert", "fix_images",
    "create_images_from_noise", "sample", "distributed_generate_and_invert",
    "fast_legs", "pretrain_prev"])
def test_fast_g_callers_end_in_u_and_its_head(monkeypatch, tmp_path, caller):
    """Every caller of the fast G runs G's second stage and output conv as
    U's fused head (its plain version on the CPU): one call of
    ``upsample2_conv3x3_head`` per chunk of G's forward, on the chunk."""
    nets = _port_nets(31)
    gv, rv = (bridge.module_variables(nets[k]) for k in ("G", "R"))
    head = upsample_conv_kernel.upsample2_conv3x3_head
    rows = []

    def counted(x, *args, **kwargs):
        rows.append(x.shape[0])
        return head(x, *args, **kwargs)
    monkeypatch.setattr(upsample_conv_kernel, "upsample2_conv3x3_head",
                        counted)
    n, batch = 40, 16
    z = torch.randn(n, SMALL_ND, generator=_gen(1))
    kw = dict(dims=SMALL, noise_dim=SMALL_ND)
    stage2 = dict(kw, n=n, noise_method="normal", batch_size=batch)
    chunks = [batch] * 3  # 40 rows in chunks of 16, the last one padded
    if caller == "variation_sweep":
        P.variation_sweep(gv, noise_method="normal", base=z[0],
                          batch_size=batch, **kw)
        chunks = [batch] * (SMALL_ND * 16 // batch)
    elif caller == "generate_and_invert":
        P.generate_and_invert(gv, rv, generator=_gen(2), **stage2)
    elif caller == "fix_images":
        P.fix_images(gv, z, batch_size=batch, **kw)
    elif caller == "create_images_from_noise":
        sampling.create_images_from_noise(nets["G"], gv, z, batch)
    elif caller == "sample":
        sample.main(["--network", _gd_checkpoint(str(tmp_path / "gd"), nets),
                     "--writeto", str(tmp_path / "out"), "--dataset",
                     "synthetic"])
        chunks = [sample.CHUNK] * (sample.N_SAMPLES // sample.CHUNK)
    elif caller == "distributed_generate_and_invert":
        distributed.distributed_generate_and_invert(
            gv, rv, generator=_gen(2), mesh=par.make_mesh(), **stage2)
    elif caller == "fast_legs":
        e2e.fast_legs(SMALL, SMALL_ND, "normal", torch.float32)["g_apply"](
            gv, z)
        chunks = [n]
    else:
        pretrain_prev.main(_pretrain_prev_args(
            _gd_checkpoint(str(tmp_path / "gd"), nets), str(tmp_path / "s")))
        chunks = [8] * 3  # one G_prev forward per batch
    assert rows == chunks


class _PerChunk:
    """Wraps a fast-forward factory: every forward it makes prepares its
    weights on every ``run``, the per-chunk form ``f(variables, chunk)``."""

    def __init__(self, make):
        self.make = make

    def __call__(self, *args, **kwargs):
        f = self.make(*args, **kwargs)
        prepare, run = f.prepare, f.run
        f.prepare = lambda variables: variables
        f.run = lambda variables, *a, **kw: run(prepare(variables), *a, **kw)
        return f


@pytest.mark.parametrize("caller", ["sample", "distributed",
                                    "pretrain_prev"])
def test_callers_prepare_each_forward_once(monkeypatch, tmp_path, caller):
    """cli.sample (G and D), the distributed stage ② on a one-rank mesh
    (G, R and the fixer-R) and cli.pretrain_prev (G_prev and D_prev)
    prepare each fast forward once per call, not once per chunk or batch,
    and give bitwise what the per-chunk form gives."""
    nets = _port_nets(32)
    if caller == "sample":
        module, names = sample, ("make_fast_generator",
                                 "make_fast_discriminator")
        network = _gd_checkpoint(str(tmp_path / "gd"), nets)

        def call(label):
            out = sample.main(["--network", network, "--writeto",
                               str(tmp_path / label), "--dataset",
                               "synthetic"])
            return [out["images"], out["preds"]]
    elif caller == "distributed":
        module, names = distributed, ("make_fast_generator",
                                      "make_fast_inverter", "make_fast_fixer")
        gv, rv, rfv = (bridge.module_variables(nets[k])
                       for k in ("G", "R", "RF"))

        def call(label):
            return [t.numpy() for t in
                    distributed.distributed_generate_and_invert(
                        gv, rv, dims=SMALL, n=40, noise_dim=SMALL_ND,
                        noise_method="normal", generator=_gen(5),
                        mesh=par.make_mesh(), batch_size=16,
                        rf_variables=rfv, fixer_generator=_gen(6))]
    else:
        module, names = pretrain_prev, ("make_fast_generator",
                                        "make_fast_discriminator")
        prev = _gd_checkpoint(str(tmp_path / "gd"), nets)

        def call(label):
            out = pretrain_prev.main(_pretrain_prev_args(
                prev, str(tmp_path / label)))
            return [np.asarray(out["g_losses"]), np.asarray(out["d_losses"])]
    makes = {name: getattr(module, name) for name in names}
    counters = {name: _CountingPrepare(make) for name, make in makes.items()}
    for name, counter in counters.items():
        monkeypatch.setattr(module, name, counter)
    once = call("once")
    assert {name: c.calls for name, c in counters.items()} == dict.fromkeys(
        names, 1)
    for name, make in makes.items():
        monkeypatch.setattr(module, name, _PerChunk(make))
    per_chunk = call("per_chunk")
    assert len(once) == len(per_chunk)
    for a, b in zip(once, per_chunk):
        np.testing.assert_array_equal(a, b)
