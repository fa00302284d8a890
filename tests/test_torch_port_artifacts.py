"""The port's training artifacts against the JAX package: the epoch-stamped
image grid (utils/grids.py), the loss chart (io/plots.py), and the train_r
CLI's preemption path (io/preemption.py). Same numpy inputs on both sides;
the grids and charts are compared bitwise (the same numpy and PIL code)."""
import os
import signal

import numpy as np
import pytest
import torch

from ganreverser_tpu.io import plots as jplots
from ganreverser_tpu.utils import grids as jgrids
from ganreverser_tpu_torch.cli import train_r
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.io import plots
from ganreverser_tpu_torch.io.preemption import PreemptionGuard
from ganreverser_tpu_torch.models import bridge, modules, zoo
from ganreverser_tpu_torch.utils import grids

from torch_port_fixtures import one_thread  # noqa: F401


@pytest.mark.parametrize("epoch,shape", [(None, (6, 8, 8, 3)),
                                         (7, (6, 8, 8, 1)),
                                         (1234, (32, 8, 8, 3)),
                                         (123456789, (2, 4, 4, 3))])
def test_epoch_grid_matches_jax(rng, epoch, shape):
    """Tiles, the 7-pixel strip and its digits (cut at the left edge when
    the number is wider than the grid) as the JAX grid draws them."""
    images = rng.uniform(size=shape).astype(np.float32)
    out = grids.images_to_grid(images, 4, 8, epoch)
    np.testing.assert_array_equal(out, jgrids.images_to_grid(images, 4, 8,
                                                             epoch))


@pytest.mark.parametrize("rows", [[], [[100, 0.5, 0.7, 0.9]],
                                  [[100, 0.5, 0.7, 0.9], [200, 0.4, float("nan"),
                                                          0.8],
                                   [300, 0.3, 0.5, 0.6]]])
def test_loss_chart_matches_jax(rows):
    labels = ["batch", "R loss (low)", "R loss (avg)", "R loss (high)"]
    out = plots.render_chart(rows, labels, title="R Loss")
    np.testing.assert_array_equal(
        out, jplots.render_chart(rows, labels, title="R Loss"))
    assert out.shape == (360, 640, 3) and out.dtype == np.uint8


def test_preemption_checkpoints_and_stops(tmp_path, monkeypatch):
    """A guard that latched a signal: train_r finishes its first segment
    (to the first preview boundary, batch 25), checkpoints that step and
    exits, and the signal handlers are restored."""
    dims, nd = (1, 8, 8), 8
    save = str(tmp_path / "logs")
    G = modules.init_parameters(zoo.create_G3(dims, nd),
                                torch.Generator().manual_seed(0))
    ckpt.save_checkpoint(ckpt.adversarial_name(save),
                         {"G": bridge.export_variables(G)},
                         config={"noiseDim": nd, "noiseMethod": "normal",
                                 "colorSpace": "y", "height": 8, "width": 8})
    guards = []

    class Latched(PreemptionGuard):
        def __init__(self):
            super().__init__()
            self.trigger()
            guards.append(self)

    monkeypatch.setattr(train_r, "PreemptionGuard", Latched)
    handler = signal.getsignal(signal.SIGTERM)
    out = train_r.main(["--G", ckpt.adversarial_name(save), "--save", save,
                        "--nbBatches", "100", "--batchSize", "4"])
    assert out["ts"].step == 25 and len(out["losses"]) == 25
    assert ckpt.load_checkpoint(out["checkpoint"])[2]["batch"] == 25
    assert os.path.isfile(os.path.join(save, "images_r", "g_r_g_000025.png"))
    assert len(guards) == 1 and guards[0].should_stop
    assert signal.getsignal(signal.SIGTERM) == handler
