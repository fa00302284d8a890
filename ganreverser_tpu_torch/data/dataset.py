"""Image directory pipeline — dataset.lua on the host (PIL + numpy), NHWC,
the counterpart of ganreverser_tpu/data/dataset.py.

* whole NHWC float32 batches, moved to the card by data/prefetch.py;
* JPEG decode (PIL, imported only when a directory is read) with the
  optional DCT-scaled draft mode, in a thread pool; the bilinear resize
  and the [-1, 1] normalisation run on the port's host image library
  (native/imageops.cc, the JAX package's C++ ops, built with g++ at first
  use), or on its numpy path where no compiler builds it;
* 'synthetic' as the dataset directory selects the procedural faces of
  data/synthetic.py, so every pipeline runs without real data.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ..native import imageops
from .colorspace import rgb_to_colorspace
from .hostmem import disable_hugepage_madvise
from .synthetic import synthetic_faces

# NN_UTILS.normalize's stored (mean, std): the reference's dummy values
# (nn_utils.lua:377-378), which travel in the checkpoint
NORMALIZE_STATS = (0.5, 0.5)


def scan_image_paths(dirs: Sequence[str], ext: str = "jpg") -> List[str]:
    """dataset.loadPaths (dataset.lua:67-93): every file with the extension
    (case-insensitive, '.jpeg' too for 'jpg', as the JAX package matches),
    sorted; raises when a directory is missing or yields nothing."""
    files: List[str] = []
    for d in dirs:
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"dataset directory {d!r} does not exist (pass a directory "
                "of *.jpg images, or 'synthetic')")
        suffixes = ("." + ext.lower(),)
        if ext.lower() == "jpg":
            suffixes += (".jpeg",)
        found = [os.path.join(d, name) for name in os.listdir(d)
                 if name.lower().endswith(suffixes)]
        if not found:
            raise FileNotFoundError(
                f"directory {d!r} doesn't contain any files of type: {ext}")
        files.extend(found)
    files.sort()
    return files


def resize_bilinear(images: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(n, sh, sw, c) float32 -> (n, dh, dw, c), bilinear with half-pixel
    centres (align_corners=False), edges clamped: the C++ image op
    (native/imageops.cc) where the library is built, else
    :func:`resize_bilinear_numpy`."""
    out = imageops.resize_bilinear_batch(images, dh, dw)
    return out if out is not None else resize_bilinear_numpy(images, dh, dw)


def resize_bilinear_numpy(images: np.ndarray, dh: int,
                          dw: int) -> np.ndarray:
    """The numpy path of :func:`resize_bilinear`,
    ganreverser_tpu/native/imageops.py::_resize_numpy."""
    n, sh, sw, c = images.shape
    fy = (np.arange(dh, dtype=np.float32) + 0.5) * (sh / dh) - 0.5
    fx = (np.arange(dw, dtype=np.float32) + 0.5) * (sw / dw) - 0.5
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    wy = (fy - y0)[None, :, None, None]
    wx = (fx - x0)[None, None, :, None]
    y0c = np.clip(y0, 0, sh - 1)
    y1c = np.clip(y0 + 1, 0, sh - 1)
    x0c = np.clip(x0, 0, sw - 1)
    x1c = np.clip(x0 + 1, 0, sw - 1)
    p00 = images[:, y0c][:, :, x0c]
    p01 = images[:, y0c][:, :, x1c]
    p10 = images[:, y1c][:, :, x0c]
    p11 = images[:, y1c][:, :, x1c]
    top = p00 * (1 - wx) + p01 * wx
    bot = p10 * (1 - wx) + p11 * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def _decode_resize(path: str, height: int, width: int,
                   draft: bool = True) -> np.ndarray:
    """Decode one image to RGB float32 in [0, 1] and resize it bilinearly.
    ``draft`` lets libjpeg decode at the smallest DCT scale (1/2, 1/4, 1/8)
    still >= the target; ``draft=False`` decodes at full size."""
    from PIL import Image
    with Image.open(path) as im:
        if draft and im.format == "JPEG":
            im.draft("RGB", (width, height))
        im = im.convert("RGB")
        arr = np.asarray(im, np.float32) / 255.0
    if arr.shape[:2] != (height, width):
        arr = resize_bilinear(np.ascontiguousarray(arr)[None], height,
                              width)[0]
    return arr


class Dataset:
    """The dataset.lua module as an object (its setters become constructor
    arguments)."""

    def __init__(self, dirs: Sequence[str], *, height: int = 32,
                 width: int = 32, colorspace: str = "rgb",
                 file_extension: str = "jpg", seed: int = 1,
                 decode_workers: Optional[int] = None,
                 decode_draft: bool = True,
                 cache_dir: Optional[str] = None):
        disable_hugepage_madvise()
        self.dirs = list(dirs)
        self.height = height
        self.width = width
        self.colorspace = colorspace
        self.file_extension = file_extension
        self._rng = np.random.default_rng(seed)
        self._paths: Optional[List[str]] = None
        self.synthetic = len(self.dirs) == 1 and self.dirs[0] == "synthetic"
        # PIL releases the GIL inside libjpeg, so decoding scales with a
        # thread pool on a multi-core host
        if decode_workers is None:
            decode_workers = os.cpu_count() or 1
        self.decode_workers = max(1, int(decode_workers))
        self.decode_draft = decode_draft
        self.cache_dir = cache_dir
        self._cache = None
        self._pool = None

    def _decode_pool(self):
        """One executor per Dataset, made at first use; a finalizer shuts
        its idle workers down when the Dataset is collected."""
        if self._pool is None:
            import weakref
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                self.decode_workers, thread_name_prefix="jpeg-decode")
            weakref.finalize(self, self._pool.shutdown, wait=False)
        return self._pool

    @property
    def paths(self) -> List[str]:
        if self._paths is None:
            self._paths = scan_image_paths(self.dirs, self.file_extension)
        return self._paths

    def size(self) -> int:
        return 100000 if self.synthetic else len(self.paths)

    def _finish(self, images: np.ndarray) -> np.ndarray:
        return rgb_to_colorspace(images, self.colorspace)

    def _get_cache(self):
        if self.cache_dir is not None and self._cache is None:
            from .cache import DecodedCache
            self._cache = DecodedCache(self.cache_dir, self.paths,
                                       self.height, self.width,
                                       decode_draft=self.decode_draft)
        return self._cache

    def _decode_into(self, indices: Sequence[int]) -> np.ndarray:
        """Decode the files at ``indices`` (positions in ``paths``) into one
        preallocated batch, each worker writing its own rows; with a cache,
        cached rows come from the disk slab and fresh decodes warm it."""
        out = np.empty((len(indices), self.height, self.width, 3),
                       np.float32)
        cache = self._get_cache()

        def decode_row(i):
            gi = indices[i]
            if cache is not None and cache.hit(gi):
                out[i] = cache.get(gi)
                return
            out[i] = _decode_resize(self.paths[gi], self.height, self.width,
                                    self.decode_draft)
            if cache is not None:
                cache.put(gi, out[i])

        if self.decode_workers > 1 and len(indices) > 1:
            # list() drains the map, so a worker's exception raises here
            list(self._decode_pool().map(decode_row, range(len(indices))))
        else:
            for i in range(len(indices)):
                decode_row(i)
        return out

    def load_images(self, start_at: int, count: int) -> np.ndarray:
        """dataset.loadImages (dataset.lua:99-131): sequential, 0-based
        start index (the reference is 1-based)."""
        if self.synthetic:
            return self._finish(synthetic_faces(
                count, self.height, self.width,
                np.random.default_rng(start_at)))
        n = min(count, len(self.paths) - start_at)
        imgs = self._decode_into(range(start_at, start_at + n))
        return self._finish(imgs)

    def load_random_images(self, count: int) -> np.ndarray:
        """dataset.loadRandomImages (dataset.lua:137-173): a fresh random
        permutation per call, count capped at the dataset size."""
        if self.synthetic:
            return self._finish(synthetic_faces(
                count, self.height, self.width, self._rng))
        perm = self._rng.permutation(len(self.paths))
        n = min(count, len(perm))
        imgs = self._decode_into([int(perm[i]) for i in range(n)])
        return self._finish(imgs)


def normalize_images(images: np.ndarray):
    """NN_UTILS.normalize (nn_utils.lua:324-379): map [0, 1] -> [-1, 1] and
    clamp, in place; returns the reference's dummy (mean, std)."""
    if not images.flags.writeable:
        raise ValueError("normalize_images mutates in place — pass a "
                         "writable array (np.array(...), not a view)")
    if not imageops.normalize_pm1_inplace(images):
        images *= 2.0
        images -= 1.0
        np.clip(images, -1.0, 1.0, out=images)
    return NORMALIZE_STATS
