"""The port's offline sampler, ``python -m
ganreverser_tpu_torch.cli.sample``, at 1x8x8 on the CPU: its seven
artifacts and run suffixes, D's ranking against the module D2, and the
neighbour search against a numpy L2 search."""
import os

import numpy as np
import pytest
import torch

from ganreverser_tpu_torch.cli import sample, train
from ganreverser_tpu_torch.io import checkpoint as ckpt
from ganreverser_tpu_torch.models import bridge, zoo
from ganreverser_tpu_torch.ops import conv_kernel

from torch_port_fixtures import one_thread  # noqa: F401

ARTIFACTS = ("trainset", "samples_256", "samples_1024", "best_64",
             "worst_64", "random_64", "neighbours")


@pytest.fixture(scope="module")
def network(tmp_path_factory):
    """A port-trained 1x8x8 G/D checkpoint (one epoch)."""
    save = str(tmp_path_factory.mktemp("sample") / "logs")
    out = train.main(["--dataset", "synthetic", "--colorSpace", "y",
                      "--height", "8", "--width", "8", "--noiseDim", "8",
                      "--batchSize", "8", "--N_epoch", "2", "--epochs", "1",
                      "--save", save, "--noplot"])
    return out["checkpoint"]


def test_sample_writes_artifacts_and_ranks_like_module_d(network, tmp_path):
    """--runs 2 --neighbours: every artifact with its _NNNN suffix; the
    best/worst order is the order of the module D2's scores on the same
    images (f32: B6's plain version and the module agree bitwise here);
    no B6 launch on the CPU."""
    out_dir = str(tmp_path / "out")
    before = conv_kernel.conv3x3_bn_act.launches
    out = sample.main(["--network", network, "--writeto", out_dir,
                       "--dataset", "synthetic", "--runs", "2",
                       "--neighbours", "--neighbours_max", "300"])
    assert conv_kernel.conv3x3_bn_act.launches == before
    assert sorted(os.listdir(out_dir)) == sorted(
        f"{name}_{run:04d}.jpg" for name in ARTIFACTS for run in (1, 2))
    tree = ckpt.load_checkpoint(network)[0]
    D = bridge.load_jax_variables(zoo.create_D((1, 8, 8)), tree["D"])
    with torch.no_grad():
        scores = D(torch.from_numpy(out["images"])).reshape(-1).numpy()
    np.testing.assert_array_equal(out["preds"], scores)
    np.testing.assert_array_equal(out["order"],
                                  np.argsort(-scores, kind="stable"))
    assert out["images"].shape == (1024, 8, 8, 1)


def test_sample_single_run_keeps_plain_names(network, tmp_path):
    out_dir = str(tmp_path / "one")
    sample.main(["--network", network, "--writeto", out_dir, "--dataset",
                 "synthetic"])
    assert sorted(os.listdir(out_dir)) == sorted(
        f"{name}.jpg" for name in ARTIFACTS[:-1])


@pytest.mark.parametrize("n_train", [10, 11, 8, 3])
def test_nearest_neighbours_match_numpy(n_train):
    """The chunked device search (chunks of 4, the last one padded with
    copies of its row 0) against a numpy L2 search over the same images;
    the best rows include a copy of a short chunk's row 0."""
    rng = np.random.default_rng(n_train)
    train_imgs = rng.uniform(size=(n_train, 4, 4, 1)).astype(np.float32)
    best = rng.uniform(size=(5, 4, 4, 1)).astype(np.float32)
    best[1] = train_imgs[(n_train - 1) // 4 * 4]

    def load(start, count):
        return train_imgs[start:start + count]

    d, imgs = sample.nearest_neighbours(torch.from_numpy(best), load,
                                        n_train, chunk=4)
    flat_b = best.reshape(5, -1).astype(np.float64)
    flat_t = train_imgs.reshape(n_train, -1).astype(np.float64)
    ref_d = ((flat_b[:, None, :] - flat_t[None]) ** 2).sum(-1)
    ref_i = ref_d.argmin(1)
    np.testing.assert_array_equal(imgs, train_imgs[ref_i])
    np.testing.assert_allclose(d, ref_d.min(1), atol=1e-5)
