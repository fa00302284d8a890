"""The port's adversarial trainer, ``python -m
ganreverser_tpu_torch.cli.train``, at 1x8x8 on the CPU: its artifacts and
flags, and its checkpoints across packages (a JAX run resumes in the port
and a port run in JAX; the JAX-written warm starts load)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from ganreverser_tpu import io as gio
from ganreverser_tpu import models as M
from ganreverser_tpu.cli import sample as j_sample
from ganreverser_tpu.cli import train as j_train
from ganreverser_tpu_torch.cli import train, train_r
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.ops import conv_kernel

from torch_port_fixtures import one_thread  # noqa: F401

ND = 8
GEOM = ["--dataset", "synthetic", "--colorSpace", "y", "--height", "8",
        "--width", "8", "--noiseDim", str(ND), "--batchSize", "8",
        "--N_epoch", "2"]


def _tree_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _events(save):
    with open(os.path.join(save, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_writes_every_artifact(tmp_path, capsys):
    """Three epochs, saved each epoch with --keep_history 2 and
    --normalize: the grids, the loss chart, the event log, two
    epoch-stamped copies, the normalisation statistics in the checkpoint;
    the confusion total of each epoch; no B6 launch on the CPU."""
    save = str(tmp_path / "logs")
    before = conv_kernel.conv3x3_bn_act.launches
    out = train.main(GEOM + ["--save", save, "--epochs", "3", "--saveFreq",
                             "1", "--keep_history", "2", "--normalize"])
    printed = capsys.readouterr().out
    assert "ConfusionMatrix:" in printed and "--prng threefry" in printed
    assert conv_kernel.conv3x3_bn_act.launches == before
    assert [r["epoch"] for r in out["epochs"]] == [1, 2, 3]
    for r in out["epochs"]:
        assert sum(map(sum, r["counts"])) == 2 * 8
        assert len(r["d_losses"]) == len(r["g_losses"]) == 2
        assert np.isfinite(r["d_losses"] + r["g_losses"]).all()
    images = sorted(os.listdir(os.path.join(save, "images")))
    assert images == sorted([f"{t}_{e:06d}.png" for e in (1, 2, 3)
                             for t in ("samples", "best", "worst")]
                            + ["plot_loss.png"])
    tags = {r["tag"] for r in _events(save)}
    assert tags == {"d_loss", "g_loss", "d_accuracy", "sanity_diag_pred",
                    "sanity_face_pred"}
    assert sorted(d for d in os.listdir(save) if ".step" in d) == [
        "adversarial.step2", "adversarial.step3"]
    tree, cfg, extra = ckpt.load_checkpoint(out["checkpoint"])
    assert extra["epoch"] == 3 and extra["normalize_mean"] == 0.5
    assert extra["normalize_std"] == 0.5 and cfg["normalize"]
    assert [row[0] for row in extra["plot_data"]] == [1, 2, 3]
    assert int(tree["G"]["step"]) == int(tree["D"]["step"]) == 6
    assert tree["G"]["step"].dtype == np.int32
    assert tree["vis_noise_inputs"].shape == (100, ND)


@pytest.mark.parametrize("flags", [["--mesh_data", "2"], ["--mesh_model", "2"],
                                   ["--async_save"], ["--mesh_data", "0"],
                                   ["--mesh_model", "4"],
                                   ["--coordinator_address", "localhost:1"]])
def test_cli_refuses_unported_flags(tmp_path, flags):
    """None of these flags is refused as unported any more. One process is
    one rank: a mesh larger than it, and a coordinator without a process
    count, are refused with the JAX package's messages before anything is
    written; --async_save and --mesh_data 0 (all ranks: one) train."""
    refused = {"--mesh_data 2": "mesh (2 data x 1 model) does not fit 1 "
                                "devices",
               "--mesh_model 2": "model axis 2 exceeds the 1 available "
                                 "devices",
               "--mesh_model 4": "model axis 4 exceeds the 1 available "
                                 "devices",
               "--coordinator_address localhost:1": "--coordinator_address "
               "needs --num_processes > 0 and --process_id >= 0 (got 0, -1)"}
    args = GEOM + ["--save", str(tmp_path), "--epochs", "1"] + flags
    message = refused.get(" ".join(flags))
    if message is not None:
        with pytest.raises(ValueError) as e:
            train.main(args)
        assert str(e.value) == message
        assert not os.path.exists(os.path.join(str(tmp_path),
                                               "events.jsonl"))
        return
    out = train.main(args)
    assert [r["epoch"] for r in out["epochs"]] == [1]
    assert ckpt.load_checkpoint(out["checkpoint"])[2]["epoch"] == 1


def test_jax_run_resumes_in_port(tmp_path):
    """A JAX train run of one epoch continues in the port with --network
    latest: at epoch 2, the same visualisation noise, the loss history
    continued, the step counts going on."""
    save = str(tmp_path / "logs")
    j_train.main(GEOM + ["--save", save, "--epochs", "1", "--saveFreq", "1"])
    j_tree, _, j_extra = gio.load_checkpoint(gio.adversarial_name(save))
    out = train.main(GEOM + ["--save", save, "--epochs", "2", "--network",
                             "latest"])
    assert [r["epoch"] for r in out["epochs"]] == [2]
    np.testing.assert_array_equal(out["vis_noise"].numpy(),
                                  j_tree["vis_noise_inputs"])
    tree, _, extra = ckpt.load_checkpoint(out["checkpoint"])
    assert extra["epoch"] == 2
    assert extra["plot_data"][0] == j_extra["plot_data"][0]
    assert [row[0] for row in extra["plot_data"]] == [1, 2]
    assert int(tree["G"]["step"]) == int(tree["D"]["step"]) == 4
    np.testing.assert_array_equal(tree["vis_noise_inputs"],
                                  j_tree["vis_noise_inputs"])


def test_port_run_resumes_in_jax(tmp_path):
    """A port run of one epoch continues in the JAX trainer, loads in the
    JAX sample CLI, and serves as the G of the port's train_r."""
    save = str(tmp_path / "logs")
    out = train.main(GEOM + ["--save", save, "--epochs", "1", "--saveFreq",
                             "1", "--noplot"])
    path = out["checkpoint"]
    vis = out["vis_noise"].numpy()
    j_train.main(GEOM + ["--save", save, "--epochs", "2", "--network",
                         "latest", "--noplot"])
    tree, _, extra = gio.load_checkpoint(path)
    assert extra["epoch"] == 2 and len(extra["plot_data"]) == 2
    assert int(tree["D"]["step"]) == 4
    np.testing.assert_array_equal(tree["vis_noise_inputs"], vis)
    j_sample.main(["--network", path, "--writeto", str(tmp_path / "s"),
                   "--dataset", "synthetic"])
    assert os.path.isfile(str(tmp_path / "s" / "best_64.jpg"))
    r = train_r.main(["--G", path, "--save", save, "--nbBatches", "2",
                      "--batchSize", "4", "--noplot"])
    assert r["ts"].step == 2 and np.isfinite(r["losses"]).all()


def _jax_variables(model, in_shape, seed):
    v, _ = model.init(jax.random.PRNGKey(seed), in_shape)
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.mark.parametrize("which", ["pretrained", "g_pretrained", "none"])
def test_warm_starts(tmp_path, which):
    """pretrained_1x8x8_nd8 (G and D) and g_pretrained_1x8x8_nd8 (G),
    written by the JAX package, seed the port's run; --nopretraining
    ignores them. --epochs 0 saves the starting weights."""
    save = str(tmp_path / "logs")
    dims = (1, 8, 8)
    gv = _jax_variables(M.create_G(dims, ND), (ND,), 3)
    dv = _jax_variables(M.create_D(dims), (8, 8, 1), 4)
    gio.save_checkpoint(gio.pretrained_name(save, 1, 8, 8, ND),
                        {"G": gv, "D": dv})
    gio.save_checkpoint(gio.g_pretrained_name(str(tmp_path / "pre"), 1, 8, 8,
                                              ND), gv)
    if which == "pretrained":
        flags = []
    else:  # the G-only warm start is read when no pretrained G+D exists
        os.rename(gio.pretrained_name(save, 1, 8, 8, ND), save + "_moved")
        flags = ["--G_pretrained_dir", str(tmp_path / "pre")]
    if which == "none":
        flags.append("--nopretraining")
    out = train.main(GEOM + ["--save", save, "--epochs", "0"] + flags)
    assert out["epochs"] == []
    tree = ckpt.load_checkpoint(out["checkpoint"])[0]
    same_g = all(np.array_equal(a, b) for a, b in zip(
        _tree_leaves(tree["G"]["params"]), _tree_leaves(gv["params"])))
    same_d = all(np.array_equal(a, b) for a, b in zip(
        _tree_leaves(tree["D"]["params"]), _tree_leaves(dv["params"])))
    assert (same_g, same_d) == {"pretrained": (True, True),
                                "g_pretrained": (True, False),
                                "none": (False, False)}[which]
    assert int(tree["G"]["step"]) == 0 and "m" in tree["G"]["opt_state"]
    if which != "none":
        for a, b in zip(_tree_leaves(tree["G"]["state"]),
                        _tree_leaves(gv["state"])):
            np.testing.assert_array_equal(a, b)
    assert torch.isfinite(out["vis_noise"]).all()
