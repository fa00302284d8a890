"""The port's host image ops (ganreverser_tpu_torch/native: imageops.cc
behind ctypes) against its numpy paths and the JAX package's, with
tests/test_native.py's tolerances (resize and the colour matrices rtol
1e-5, atol 1e-6: the C++ loops sum in another order than numpy's
products; yuv2rgb 1e-4 / 1e-5; the grid and [-1, 1] exact), and the
callers that take them where the JAX package does (data/colorspace.py,
data/dataset.py, utils/grids.py), with the numpy path where no compiler
is found."""
import os

import numpy as np
import pytest

from ganreverser_tpu import native as jnative
from ganreverser_tpu.data import colorspace as jcs
from ganreverser_tpu.native.imageops import _resize_numpy
from ganreverser_tpu.utils import grids as jgrids
from ganreverser_tpu_torch import native
from ganreverser_tpu_torch.data import colorspace as cs
from ganreverser_tpu_torch.data import dataset
from ganreverser_tpu_torch.native import imageops
from ganreverser_tpu_torch.utils import grids

from torch_port_fixtures import one_thread  # noqa: F401


def test_native_builds_into_build_dir():
    """g++ builds the library at first use under build/native/ at the root
    of the checkout, named by the source's hash, not beside the source."""
    assert native.available(), imageops._LIBRARY.failure
    lib = imageops._LIBRARY.path()
    assert lib.is_file() and lib.parent == imageops.BUILD_DIR
    assert imageops.BUILD_DIR.parts[-2:] == ("build", "native")
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(imageops.__file__)))


def test_source_is_the_jax_packages():
    """The same functions, line for line, as the JAX package's C++ (only
    the header comment differs)."""
    def body(path):
        with open(path) as f:
            return [line for line in f if not line.startswith("//")]
    jax_src = os.path.join(os.path.dirname(jnative.__file__), "imageops.cc")
    assert body(imageops.SOURCE) == body(jax_src)


@pytest.mark.parametrize("shape,out", [((3, 17, 13, 3), (8, 8)),
                                       ((3, 17, 13, 3), (32, 32)),
                                       ((2, 64, 48, 1), (16, 24))])
def test_resize_matches_numpy(rng, shape, out):
    x = rng.random(shape, np.float32)
    a = native.resize_bilinear_batch(x, *out)
    for ref in (dataset.resize_bilinear_numpy(x, *out),
                _resize_numpy(x, *out),
                jnative.resize_bilinear_batch(x, *out)):
        np.testing.assert_allclose(a, ref, rtol=1e-5, atol=1e-6)
    assert a.shape == (shape[0],) + out + (shape[-1],)
    np.testing.assert_array_equal(dataset.resize_bilinear(x, *out), a)


def test_colorspace_matches_numpy(rng):
    x = rng.random((2, 8, 8, 3), np.float32)
    np.testing.assert_allclose(native.rgb2y_native(x), cs.rgb2y(x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(native.rgb2yuv_native(x), cs.rgb2yuv(x),
                               rtol=1e-5, atol=1e-6)
    yuv = cs.rgb2yuv(x)
    np.testing.assert_allclose(native.yuv2rgb_native(yuv), cs.yuv2rgb(yuv),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("space", ["y", "yuv", "hsl", "rgb"])
def test_conversions_take_the_native_ops(rng, space):
    """rgb_to_colorspace and to_rgb run the C++ op for y and yuv, as the
    JAX package's do: bitwise the JAX package's results."""
    x = rng.random((3, 8, 8, 3), np.float32)
    a = cs.rgb_to_colorspace(x, space)
    np.testing.assert_array_equal(a, jcs.rgb_to_colorspace(x, space))
    np.testing.assert_array_equal(cs.to_rgb(a, space), jcs.to_rgb(a, space))
    if space == "yuv":
        np.testing.assert_array_equal(a, native.rgb2yuv_native(x))
        np.testing.assert_array_equal(cs.to_rgb(a, space),
                                      native.yuv2rgb_native(a))


def test_normalize_inplace(rng):
    x = rng.random((4, 4), np.float32) * 1.2  # some values > 1 to clamp
    ref = np.clip(x * 2.0 - 1.0, -1.0, 1.0)
    y = x.copy()
    assert native.normalize_pm1_inplace(x)
    np.testing.assert_allclose(x, ref, rtol=1e-6)
    assert dataset.normalize_images(y) == dataset.NORMALIZE_STATS
    np.testing.assert_array_equal(y, x)
    assert not native.normalize_pm1_inplace(np.ones(4))  # float64: numpy


@pytest.mark.parametrize("epoch", [None, 12])
def test_assemble_grid_matches_python(rng, epoch):
    imgs = rng.random((5, 4, 4, 3), np.float32)
    a = native.assemble_grid(imgs, 2, 3, strip=0)
    b = jgrids.images_to_grid(imgs, 2, 3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(grids.images_to_grid(imgs, 2, 3, epoch),
                                  jgrids.images_to_grid(imgs, 2, 3, epoch))


def test_numpy_paths_without_a_compiler(rng, monkeypatch):
    """With no g++ on the PATH (and no library built for this source) the
    entry points return None or False and the callers take their numpy
    paths, within the tolerances above of the C++ results."""
    x = rng.random((2, 9, 7, 3), np.float32)
    want = {"y": cs.rgb_to_colorspace(x, "y"),
            "yuv": cs.rgb_to_colorspace(x, "yuv"),
            "resize": dataset.resize_bilinear(x, 4, 4),
            "grid": grids.images_to_grid(x, 1, 2, 3)}
    lib = imageops._Library()
    monkeypatch.setattr(imageops, "_LIBRARY", lib)
    monkeypatch.setattr(lib, "path", lambda: imageops.BUILD_DIR / "none.so")
    monkeypatch.setattr(imageops.shutil, "which", lambda name: None)
    assert not native.available() and lib.failure == "g++ not found"
    assert native.rgb2y_native(x) is None
    assert native.assemble_grid(x, 1, 2) is None
    assert not native.normalize_pm1_inplace(x.copy())
    got = {"y": cs.rgb_to_colorspace(x, "y"),
           "yuv": cs.rgb_to_colorspace(x, "yuv"),
           "resize": dataset.resize_bilinear(x, 4, 4),
           "grid": grids.images_to_grid(x, 1, 2, 3)}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    y = x.copy()
    dataset.normalize_images(y)
    np.testing.assert_allclose(y, np.clip(x * 2 - 1, -1, 1), rtol=1e-6)
