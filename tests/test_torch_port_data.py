"""The port's host data path (data/{synthetic,dataset,colorspace,cache,
prefetch}.py) against the JAX package's: the same seeds give the same
arrays. Synthetic faces, the loaders on them in rgb and the [-1, 1]
normalisation are bitwise equal; the other colour spaces agree within
1e-6 (the JAX package may take its C++ conversions, which sum in another
order); JPEG directories within 1e-5 (the JAX package may resize with its
C++ library)."""
import threading
import time

import numpy as np
import pytest
import torch

from ganreverser_tpu import data as jdata
from ganreverser_tpu_torch.data import colorspace, dataset, prefetch
from ganreverser_tpu_torch.data.synthetic import synthetic_faces

from torch_port_fixtures import one_thread  # noqa: F401


def test_synthetic_faces_bitwise():
    a = synthetic_faces(5, 16, 12, np.random.default_rng(3))
    b = jdata.synthetic_faces(5, 16, 12, np.random.default_rng(3))
    assert a.dtype == np.float32 and a.shape == (5, 16, 12, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("space", ["rgb", "y", "yuv", "hsl"])
def test_synthetic_dataset_matches_jax(space):
    """load_images and two successive load_random_images, and the colour
    conversions both ways."""
    kw = dict(height=8, width=8, colorspace=space, seed=11)
    ours = dataset.Dataset(["synthetic"], **kw)
    ref = jdata.Dataset(["synthetic"], **kw)
    tol = 0.0 if space == "rgb" else 1e-6
    pairs = [(ours.load_images(7, 6), ref.load_images(7, 6))]
    pairs += [(ours.load_random_images(9), ref.load_random_images(9))
              for _ in range(2)]
    assert ours.size() == ref.size() == 100000
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
        np.testing.assert_allclose(colorspace.to_rgb(a, space),
                                   jdata.to_rgb(b, space), rtol=0,
                                   atol=max(tol, 1e-6))


def test_normalize_images_bitwise():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, (3, 4, 4, 3)).astype(
        np.float32)
    a, b = x.copy(), x.copy()
    assert dataset.normalize_images(a) == jdata.normalize_images(b) == \
        dataset.NORMALIZE_STATS
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        dataset.normalize_images(np.broadcast_to(x, x.shape))


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    """Nine JPEGs of 40x30 written with PIL (and a file that is not one)."""
    from PIL import Image
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(5)
    for i in range(9):
        arr = (rng.uniform(size=(30, 40, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img_{i:02d}.jpg", quality=90)
    (d / "notes.txt").write_text("not an image")
    return str(d)


@pytest.mark.parametrize("exact", [False, True])
def test_jpeg_directory_matches_jax(jpeg_dir, exact):
    """Draft and exact decodes of the same directory, in order and at
    random, to 8x8 and 16x16."""
    for h, w in ((8, 8), (16, 16)):
        kw = dict(height=h, width=w, seed=4, decode_draft=not exact)
        ours = dataset.Dataset([jpeg_dir], **kw)
        ref = jdata.Dataset([jpeg_dir], **kw)
        assert ours.paths == ref.paths and ours.size() == 9
        np.testing.assert_allclose(ours.load_images(2, 5),
                                   ref.load_images(2, 5), atol=1e-5)
        np.testing.assert_allclose(ours.load_random_images(20),
                                   ref.load_random_images(20), atol=1e-5)
    with pytest.raises(FileNotFoundError):
        dataset.Dataset(["/nonexistent"]).load_images(0, 1)


def test_decode_cache_round_trip(jpeg_dir, tmp_path):
    """A cold and a warm load through --decode_cache: the warm rows come
    from the slab, uint8-quantized (within 1/510 of the decode); the JAX
    package reads the same slab."""
    cache = str(tmp_path / "cache")
    plain = dataset.Dataset([jpeg_dir], height=8, width=8).load_images(0, 9)
    cold = dataset.Dataset([jpeg_dir], height=8, width=8, cache_dir=cache)
    np.testing.assert_array_equal(cold.load_images(0, 9), plain)
    assert cold._get_cache().fill_count == 9
    warm = dataset.Dataset([jpeg_dir], height=8, width=8, cache_dir=cache)
    got = warm.load_images(0, 9)
    assert np.abs(got - plain).max() <= 1 / 510 + 1e-7
    jwarm = jdata.Dataset([jpeg_dir], height=8, width=8, cache_dir=cache)
    np.testing.assert_array_equal(jwarm.load_images(0, 9), got)


def test_prefetch_in_order_and_reraises():
    out = list(prefetch.prefetch_to_device(
        lambda i: np.full((2, 3), i, np.float32), 5))
    assert [int(t[0, 0]) for t in out] == [0, 1, 2, 3, 4]
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in out)

    def boom(i):
        if i == 2:
            raise OSError("corrupt file")
        return np.zeros(1, np.float32)

    it = prefetch.prefetch_to_device(boom, -1)
    assert next(it).shape == (1,) and next(it).shape == (1,)
    with pytest.raises(OSError, match="corrupt"):
        next(it)
    endless = prefetch.prefetch_to_device(
        lambda i: np.full(1, i, np.float32), -1)
    assert [float(next(endless)) for _ in range(4)] == [0.0, 1.0, 2.0, 3.0]
    endless.close()
    assert threading.active_count() < 50


def test_prefetch_close_waits_for_the_worker():
    """Closing the iterator returns only once the worker has finished the
    batch it was making: nothing of it runs on after the close."""
    started, finished = [], []

    def slow(i):
        started.append(i)
        time.sleep(0.2)
        finished.append(i)
        return np.full(1, i, np.float32)

    it = prefetch.prefetch_to_device(slow, -1)
    assert float(next(it)) == 0.0
    it.close()
    assert started == finished and len(started) >= 2
