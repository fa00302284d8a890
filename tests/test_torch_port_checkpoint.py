"""The port's checkpoint format and weight bridge against the JAX package:
a checkpoint written by either package loads in the other, and the bridge
carries a JAX model's variables into the port's modules and back."""
import jax
import numpy as np
import pytest
import torch

from ganreverser_tpu import io as gio
from ganreverser_tpu import models as M
from ganreverser_tpu_torch.io import checkpoint as tckpt
from ganreverser_tpu_torch.models import bridge, zoo

from torch_port_fixtures import one_thread  # noqa: F401

DIMS, ND = (3, 16, 16), 8


def _tree(rng):
    return {"G": {"params": {"l0": {"kernel": rng.normal(size=(4, 6)).astype(np.float32),
                                     "bias": np.zeros(6, np.float32)}},
                  "state": {"l1": {"mean": rng.normal(size=6).astype(np.float32)}}},
            "shape": (3, 16, 16), "names": ["a", "b"], "step": np.int32(7),
            "flag": True, "none": None}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray) or hasattr(a, "shape"):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(tmp_path, rng, writer):
    tree = _tree(rng)
    cfg = {"noiseDim": ND, "noiseMethod": "normal"}
    path = str(tmp_path / "ck")
    if writer == "jax":
        gio.save_checkpoint(path, tree, config=cfg, extra={"epoch": 3})
        got, got_cfg, extra = tckpt.load_checkpoint(path)
    else:
        tckpt.save_checkpoint(path, tree, config=cfg, extra={"epoch": 3})
        got, got_cfg, extra = gio.load_checkpoint(path)
    _assert_tree_equal(tree, got)
    assert got_cfg == cfg and extra == {"epoch": 3}


def test_checkpoint_torch_leaves_backup_and_names(tmp_path):
    path = str(tmp_path / "ck")
    tckpt.save_checkpoint(path, {"w": torch.arange(4.0)})
    tckpt.save_checkpoint(path, {"w": torch.ones(2)})
    assert tckpt.exists(path) and tckpt.exists(path + ".old")
    np.testing.assert_array_equal(tckpt.load_checkpoint(path)[0]["w"],
                                  np.ones(2, np.float32))
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path / "missing"))
    assert tckpt.adversarial_name("s") == gio.adversarial_name("s")
    for fixer in (False, True):
        assert (tckpt.r_name("s", 3, 64, 64, 100, "normal", fixer)
                == gio.r_name("s", 3, 64, 64, 100, "normal", fixer))


@pytest.mark.parametrize("model", ["G", "R"])
def test_bridge_roundtrip_and_jax_load(model):
    key = jax.random.PRNGKey(3)
    if model == "G":
        jm, tm = M.create_G(DIMS, ND), zoo.create_G3(DIMS, ND)
        variables, _ = jm.init(key, (ND,))
    else:
        jm, tm = M.create_R(DIMS, ND, "normal"), zoo.create_R(DIMS, ND, "normal")
        variables, _ = jm.init(key, DIMS[1:] + DIMS[:1])
    bridge.load_jax_variables(tm, variables)
    back = bridge.export_variables(tm)
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray, variables), back)


def test_bridge_rejects_mismatched_architecture():
    variables, _ = M.create_R(DIMS, ND, "normal").init(
        jax.random.PRNGKey(0), (16, 16, 3))
    with pytest.raises(ValueError):
        bridge.load_jax_variables(zoo.create_R(DIMS, ND + 1, "normal"),
                                  variables)
    with pytest.raises(ValueError):
        bridge.load_jax_variables(zoo.create_G3(DIMS, ND), variables)
    del variables["state"]["l1"]["var"]
    with pytest.raises(KeyError):
        bridge.load_jax_variables(zoo.create_R(DIMS, ND, "normal"), variables)
