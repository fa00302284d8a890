"""Training and apply_r on the port's mesh (parallel/, train/, the CLIs)
on the CPU, in gloo worlds of 2 and 4 processes that import no jax
(tests/torch_port_dist_worker.py, and the CLIs themselves).

* One step on a mesh against the one-rank step on the whole batch (every
  rank draws the whole batch's latents and masks and keeps its rows; the
  BatchNorm statistics summed over 'data' through autograd; the gradients
  averaged): the DP R step (plain and kernel-B5 dropouts, the fixer-R),
  the G/D pair, and both with the parameters, the moments and G cut over
  'model'. The one-rank port step is held to JAX's by
  tests/test_torch_port_train_r.py and tests/test_torch_port_gan.py.
* The CLIs: train and train_r as 2 processes (--coordinator_address,
  --mesh_data 2, --async_save, train with a resume) against one process
  (train_r step by step: after its own steps and after --cont), the ranks
  of train_r bit for bit alike, their checkpoints loaded by the JAX
  package; apply_r with --mesh_data 2,
  --mesh_model 2 and both, each starting its own ranks, against the
  one-rank run.

Tolerances: losses, gradients and BatchNorm buffers 1e-5 of scale (sums
in another order); parameters after adam as tests/test_torch_port_train_r
.py::test_train_step_matches_jax holds them: every element within adam's
bound |dp| <= 2 lr per step, plus the rounding of the update (a
gradient within the rounding of its sum,
as those of the biases before a training-mode BatchNorm, steps either
way), and all but 1 % within 1e-5 of scale; apply_r's images and statistics
equal (the same chunks on each rank)."""
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ganreverser_tpu import io as gio
from ganreverser_tpu.cli import common as jcommon
from ganreverser_tpu_torch.cli import apply_r, common, train, train_r
from ganreverser_tpu_torch.core.prng import (INIT_STAGE, stage_generator,
                                             trainer_generators)
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.models import bridge, zoo
from ganreverser_tpu_torch.models.bridge import load_jax_variables
from ganreverser_tpu_torch.models.modules import (init_parameters,
                                                  set_dropout_generator)
from ganreverser_tpu_torch.optim import adam
from ganreverser_tpu_torch.train.r_loop import make_r_segment_program
from ganreverser_tpu_torch.train.state import TrainState

import torch_port_dist_worker as W
from torch_port_fixtures import one_thread  # noqa: F401

ND, LR = 8, 1e-3
R_DIMS = (1, 8, 8)  # GEOM's
GEOM = ["--dataset", "synthetic", "--colorSpace", "y", "--height", "8",
        "--width", "8", "--noiseDim", str(ND), "--batchSize", "8",
        "--N_epoch", "2", "--nopretraining", "--noplot"]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """world -> each rank's results of the step cases."""
    rng = np.random.default_rng(15)
    inputs = {"dims": np.array((1, 8, 8)), "nd": np.array(ND),
              "train_batch": np.array(8),
              "reals": rng.uniform(size=(4, 8, 8, 1)).astype(np.float32)}
    return {2: W.run_ranks(str(tmp_path_factory.mktemp("w2")), 2,
                           ["r_step", "r_step_tp", "gan_step"], inputs),
            4: W.run_ranks(str(tmp_path_factory.mktemp("w4")), 4,
                           ["r_step_tp", "gan_step"], inputs)}


def _scale_close(out, ref, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() if out.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _params_close(outs, refs, n_steps=1):
    """Every element within adam's bound, all but 1 % within 1e-5 of
    scale."""
    off = total = 0
    for out, ref in zip(outs, refs):
        d = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
        assert d.max() <= (2 * LR + 1e-6) * n_steps, d.max()
        off += int((d > 1e-5 * max(1.0, np.abs(ref).max())).sum())
        total += d.size
    assert off <= 0.01 * total, (off, total)


def _step_matches(out: dict, prefix: str, tag: str, nets=("",)):
    """``tag``'s step against the one-rank step in one rank's results."""
    _scale_close(out[f"{prefix}{tag}_loss"], out[f"{prefix}one_loss"])
    for net in nets:
        keys = sorted(k[len(prefix) + 4:] for k in out
                      if k.startswith(f"{prefix}one_{net}"))
        grads = [k for k in keys if k[len(net):].startswith("grad")]
        params = [k for k in keys if k[len(net):].startswith("param")]
        bufs = [k for k in keys if k[len(net):].startswith("buf_")]
        assert grads and params  # D2 has no BatchNorm (no buffers)
        for k in grads + bufs:
            _scale_close(out[f"{prefix}{tag}_{k}"], out[f"{prefix}one_{k}"])
        _params_close([out[f"{prefix}{tag}_{k}"] for k in params],
                      [out[f"{prefix}one_{k}"] for k in params])


@pytest.mark.parametrize("variant", ["plain0", "kernel0", "kernel1"])
def test_dp_r_step(steps, variant):
    """2 ranks, plain and kernel-B5 dropouts (kernel1: the fixer-R, its
    input dropout on B5 too): loss, gradients, the parameters after adam
    and the BatchNorm running statistics equal the one-rank step's."""
    for out in steps[2]:
        _step_matches(out, f"r_step/{variant}/", "mesh")


@pytest.mark.parametrize("world", [2, 4])
def test_tp_r_step(steps, world):
    """(1, 2) and (2, 2) meshes, R's and G's big kernels and R's moments
    cut over 'model' (min_size 2^10): the gathered gradients and
    parameters equal the one-rank step's, and a rank stores fewer
    parameter elements than the whole."""
    for out in steps[world]:
        _step_matches(out, "r_step_tp/tp/", "mesh")
        assert out["r_step_tp/tp/mesh_local_numel"] < \
            out["r_step_tp/tp/mesh_whole_numel"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag", ["mesh", "tp"])
def test_gan_step(steps, world, tag):
    """A D step then a G step: on a (world, 1) mesh (``mesh``) and with G
    and D cut over 'model' (``tp``): losses, both nets' gradients,
    parameters and buffers, and the confusion counts summed over the
    ranks, equal the one-rank pair's."""
    for out in steps[world]:
        _step_matches(out, "gan_step/", tag, nets=("d_", "g_"))
        assert np.array_equal(out[f"gan_step/{tag}_conf"],
                              out["gan_step/one_conf"])
        assert int(out["gan_step/one_conf"].sum()) == 8


def _cli(module: str, args: list) -> list:
    return [sys.executable, "-m", f"ganreverser_tpu_torch.cli.{module}",
            *args]


def _two_processes(module: str, args: list, dump=None) -> list:
    """The CLI ``module`` as 2 processes; with ``dump``, each through
    torch_port_dist_worker.py --cli, which writes rank r's train state
    and losses to ``dump/rank<r>.npz``."""
    port = W.free_port()
    return W.run_processes([
        (_cli(module, []) if dump is None else
         [sys.executable, W.__file__, "--cli", module,
          os.path.join(dump, f"rank{r}.npz")]) + args + [
            "--coordinator_address", f"localhost:{port}",
            "--num_processes", "2", "--process_id", str(r)]
        for r in range(2)])


def _trees_match(tree, ref, steps=None):
    """Leaf for leaf: integer leaves (the step counts) equal, float leaves
    as in :func:`_params_close` over ``steps`` steps, by default all the
    run's (a bias before a training-mode BatchNorm that stepped either way
    moves the running statistics and the moments after it, by less than it
    moved)."""
    flat, flat_ref = W.flat(tree), W.flat(ref)
    assert sorted(flat) == sorted(flat_ref)
    if steps is None:
        steps = max(int(np.max(v)) for k, v in flat_ref.items()
                    if k.endswith("step"))
    floats = [k for k in flat if flat_ref[k].dtype.kind == "f"]
    _params_close([flat[k] for k in floats], [flat_ref[k] for k in floats],
                  steps)
    for k in set(flat) - set(floats):
        assert np.array_equal(flat[k], flat_ref[k]), k


def test_two_process_train_with_async_save_and_resume(tmp_path):
    """train as 2 processes (--coordinator_address, --mesh_data 2,
    --async_save), one epoch then a resumed second: rank 0's checkpoint
    equals the one-process run's leaf for leaf, with the same loss
    history, and loads in the JAX package."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    for epochs, extra in (("1", []), ("2", ["--network", "latest"])):
        train.main(GEOM + ["--save", one, "--epochs", epochs] + extra)
        outs = _two_processes("train", GEOM + [
            "--save", two, "--epochs", epochs, "--mesh_data", "2",
            "--async_save"] + extra)
        assert "backend gloo" in outs[0] and "mesh: {'data': 2" in outs[1]
    tree, cfg, extra = ckpt.load_checkpoint(ckpt.adversarial_name(two))
    ref, _, ref_extra = ckpt.load_checkpoint(ckpt.adversarial_name(one))
    assert extra["epoch"] == ref_extra["epoch"] == 2 and cfg["async_save"]
    _scale_close(np.array(extra["plot_data"]), np.array(
        ref_extra["plot_data"]))
    _trees_match(tree, ref)
    assert not os.path.exists(os.path.join(two, "images"))  # no grids
    j_tree, _, _ = gio.load_checkpoint(gio.adversarial_name(two))
    gs = jcommon.gan_from_tree(j_tree)
    assert int(gs.g.step) == int(gs.d.step) == 4


@pytest.fixture(scope="module")
def g_checkpoint(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("g"))
    train.main(GEOM + ["--save", save, "--epochs", "1"])
    return gio.adversarial_name(save)


def _one_process_steps(g_checkpoint: str, trees: list) -> tuple:
    """From each R tree of ``trees`` in turn, one train_r step in one
    process on the whole batch, with the latents and dropout masks that
    train_r (seed 1, --dropout kernel) draws for the next batch after as
    many batches as the tree's place in the list: the R trees and losses
    after the steps."""
    g_tree, _, _ = ckpt.load_checkpoint(g_checkpoint)
    G = load_jax_variables(zoo.create_G(R_DIMS, ND), g_tree["G"])
    segment = make_r_segment_program(G, batch_size=8, noise_dim=ND,
                                     noise_method="normal",
                                     dtype=torch.float32)
    noise, drops = trainer_generators(1, torch.device("cpu"))
    after, losses = [], []
    for tree in trees:
        R = zoo.create_R(R_DIMS, ND, "normal", dropout_impl="kernel")
        ts = common.ts_from_tree(tree, R, adam(), torch.device("cpu"))
        set_dropout_generator(R, drops)
        losses.append(float(segment(ts, noise, 1)[0]))
        after.append(common.ts_to_tree(ts))
    return after, losses


def test_two_process_train_r_with_async_save(g_checkpoint, tmp_path):
    """train_r as 2 processes (--mesh_data 2, --async_save, --dropout
    kernel: B5's plain version with each rank's counter base) for 1, 2 and
    3 batches, each run one segment from the start: both ranks end with
    the R of rank 0's checkpoint and the same losses, bit for bit, and each
    run's losses begin with the shorter run's (one trajectory). Each
    checkpoint equals the one-process step on the whole batch from the one
    before (the first from train_r's initial R), with the latents and masks
    that train_r draws for that batch, as :func:`_trees_match` holds one
    step; the last loads in the JAX package.

    The one-process run is compared step by step, and not after 3 chained
    steps of its own: the two runs' states differ after a step (a bias
    before a training-mode BatchNorm steps either way), and where a 2x2
    window of the MaxPool after layer 21 holds two values 4e-6 apart
    relatively, that difference can pick the other maximum in the next
    forward and route that window's gradient elsewhere, which moves one
    channel of layer 21's gradient by a fifth of its scale and, through
    adam, a third of the elements by more than 1e-5 of scale."""
    args = ["--G", g_checkpoint, "--saveFreq", "3", "--batchSize", "8",
            "--noplot", "--dropout", "kernel", "--mesh_data", "2",
            "--async_save"]
    R = zoo.create_R(R_DIMS, ND, "normal", dropout_impl="kernel")
    init_parameters(R, stage_generator(1, INIT_STAGE, "cpu"))
    trees = [common.ts_to_tree(TrainState.create(R, adam()))]
    losses = np.zeros(0, np.float32)
    for n in (1, 2, 3):
        save = tmp_path / f"two{n}"
        _two_processes("train_r", args + ["--nbBatches", str(n), "--save",
                                          str(save)], dump=str(save))
        path = ckpt.r_name(str(save), *R_DIMS, ND, "normal", False)
        tree, _, extra = ckpt.load_checkpoint(path)
        assert extra["batch"] == n
        saved = W.flat(tree["R"], "R/")
        ranks = [dict(np.load(save / f"rank{r}.npz")) for r in range(2)]
        for rank in ranks:
            assert sorted(rank) == sorted(saved) + ["losses"]
            for k, v in saved.items():
                assert np.array_equal(rank[k], v), k
            assert np.array_equal(rank["losses"], ranks[0]["losses"])
        assert np.array_equal(ranks[0]["losses"][:-1], losses)
        losses = ranks[0]["losses"]
        trees.append(tree["R"])
    after, one_losses = _one_process_steps(g_checkpoint, trees[:-1])
    _scale_close(losses, one_losses)
    for tree, ref in zip(trees[1:], after):
        _trees_match(tree, ref, steps=1)
    j_tree, _, _ = gio.load_checkpoint(path)
    assert int(jcommon.ts_from_tree(j_tree["R"]).step) == 3


def test_two_process_train_r_steps_match(g_checkpoint, tmp_path):
    """train_r as 2 processes, as above, for one batch at a time, each run
    in both from the one-process run's last checkpoint (--cont), so that
    each comparison covers one step from one state, as
    test_torch_port_train_r.py's against JAX does: after each batch the
    checkpoint equals the one-process run's, adam's moments within adam's
    bound too."""
    args = ["--G", g_checkpoint, "--nbBatches", "1", "--saveFreq", "1",
            "--batchSize", "8", "--noplot", "--dropout", "kernel"]
    cont = []
    for batch in (1, 2, 3):
        one = train_r.main(args + cont + ["--save",
                                          str(tmp_path / f"one{batch}")])
        two = tmp_path / f"two{batch}" / os.path.basename(one["checkpoint"])
        _two_processes("train_r", args + cont + [
            "--save", str(two.parent), "--mesh_data", "2", "--async_save"])
        tree, _, extra = ckpt.load_checkpoint(str(two))
        ref, _, ref_extra = ckpt.load_checkpoint(one["checkpoint"])
        assert extra["batch"] == ref_extra["batch"] == batch
        _trees_match(tree["R"], ref["R"], steps=1)
        cont = ["--cont", one["checkpoint"]]


def _save_net(path: str, key: str, module, config: dict):
    ckpt.save_checkpoint(path, {key: bridge.export_variables(module)},
                         config=config)


@pytest.fixture(scope="module")
def apply_inputs(tmp_path_factory):
    """G3, R and the fixer-R (1x8x8, noise 8, kernels x4 so that faces
    differ) as checkpoints, and the one-rank apply_r run on them."""
    save = str(tmp_path_factory.mktemp("apply"))
    dims = (1, 8, 8)
    g = torch.Generator().manual_seed(21)
    cfg = {"noiseDim": ND, "noiseMethod": "normal", "colorSpace": "y",
           "height": 8, "width": 8}
    nets = (("adversarial", "G", zoo.create_G3(dims, ND)),
            ("r_1x8x8_nd8_normal", "R", zoo.create_R(dims, ND, "normal")),
            ("r_1x8x8_nd8_normal_fixer", "R",
             zoo.create_R(dims, ND, "normal", fixer=True)))
    for name, key, module in nets:
        init_parameters(module, g)
        with torch.no_grad():
            for n, p in module.named_parameters():
                if n.endswith("kernel"):
                    p.mul_(4.0)
        _save_net(os.path.join(save, name), key, module, cfg)
    args = ["--G", os.path.join(save, "adversarial"), "--save", save,
            "--N", "512", "--clusters", "4", "--kmeans_iters", "3",
            "--needles", "2", "--anomalies_n", "128"]
    apply_r.main(args + ["--writeto", os.path.join(save, "one")])
    return save, args


def _stats(path: str) -> list:
    with open(os.path.join(path, "apply_r_stats.jsonl")) as f:
        return [(r["tag"], r["value"], r.get("step"))
                for r in map(json.loads, f)]


@pytest.mark.parametrize("mesh", [["--mesh_data", "2"],
                                  ["--mesh_model", "2"],
                                  ["--mesh_data", "2", "--mesh_model", "2"]])
def test_apply_r_mesh_matches_one_rank(apply_inputs, mesh):
    """apply_r started as one process with a mesh starts its ranks (2, 2
    and 4) and gives the one-rank run's artifacts: every image and the
    statistics file (stage ② on the ranks' rows and the fixer's masks
    those rows of the one-rank masks; G's and R's big kernels cut over
    'model' where the mesh has one)."""
    save, args = apply_inputs
    out = os.path.join(save, "_".join(mesh).replace("--", ""))
    (log,) = W.run_processes([_cli("apply_r", args + ["--writeto", out]
                                   + mesh)])
    assert "backend gloo" in log and "ranks for the" in log
    one = os.path.join(save, "one")
    assert _stats(out) == _stats(one)
    files = sorted(f for f in os.listdir(one) if f.endswith(".jpg"))
    assert files == sorted(f for f in os.listdir(out) if f.endswith(".jpg"))
    for f in files:
        a = np.asarray(Image.open(os.path.join(out, f)))
        b = np.asarray(Image.open(os.path.join(one, f)))
        assert np.array_equal(a, b), f


def test_async_save_copies_the_snapshot(tmp_path):
    """The tree is copied before the thread writes: an in-place update
    of a CPU tensor right after the call does not reach the file, and the
    config and extra are copies too."""
    t = {"a": torch.arange(4.0), "b": np.ones(3, np.float32)}
    extra = {"plot_data": [[1, 2.0]]}
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint_async(path, t, extra=extra)
    t["a"].add_(10.0)
    t["b"] += 5.0
    extra["plot_data"].append([2, 3.0])
    ckpt.wait_for_saves()
    tree, _, got = ckpt.load_checkpoint(path)
    np.testing.assert_array_equal(tree["a"], np.arange(4.0))
    np.testing.assert_array_equal(tree["b"], np.ones(3))
    assert got["plot_data"] == [[1, 2.0]]


def test_async_save_keeps_one_in_flight_and_the_backup(tmp_path):
    """Two saves in a row: the second joins the first, so the first
    becomes <path>.old and the second the checkpoint."""
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint_async(path, {"x": np.zeros(2)})
    ckpt.save_checkpoint_async(path, {"x": np.ones(2)})
    ckpt.wait_for_saves()
    np.testing.assert_array_equal(ckpt.load_checkpoint(path)[0]["x"],
                                  np.ones(2))
    np.testing.assert_array_equal(
        ckpt.load_checkpoint(path + ".old")[0]["x"], np.zeros(2))


def test_async_save_error_surfaces(tmp_path):
    """A write that fails in the thread is raised by wait_for_saves, once,
    and by the next save when nothing waited in between."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ckpt.save_checkpoint_async(str(blocker / "ck"), {"x": np.zeros(2)})
    with pytest.raises(OSError):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()  # the error was reported once
    ckpt.save_checkpoint_async(str(blocker / "ck"), {"x": np.zeros(2)})
    with pytest.raises(OSError):
        ckpt.save_checkpoint_async(str(tmp_path / "ok"), {"x": np.zeros(2)})
    ckpt.wait_for_saves()
    assert not ckpt.exists(str(tmp_path / "ok"))
    t = ckpt._SAVER.thread
    assert t is None


def test_async_save_thread_is_not_a_daemon(tmp_path):
    ckpt.save_checkpoint_async(str(tmp_path / "ck"), {"x": np.zeros(2)})
    t = ckpt._SAVER.thread
    assert t is None or not t.daemon
    ckpt.wait_for_saves()
