"""Image grids, borders, the epoch stamp and saving — the counterpart of
ganreverser_tpu/utils/grids.py (nn_utils.lua:429-548). The grid is
assembled by the C++ image op (native/imageops.cc) where the library is
built, else by numpy."""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..native import imageops

BLUE = (0.0, 0.0, 1.0)   # similarity needle (apply_r.lua:281-296)
RED = (1.0, 0.0, 0.0)    # anomaly (apply_r.lua:376-388)

# nn_utils.lua:429-479 — digits 0..9 as 5x3 bitmaps
CHAR_TENSORS = np.array([
    [[1, 1, 1], [1, 0, 1], [1, 0, 1], [1, 0, 1], [1, 1, 1]],  # 0
    [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1]],  # 1
    [[1, 1, 1], [0, 0, 1], [1, 1, 1], [1, 0, 0], [1, 1, 1]],  # 2
    [[1, 1, 1], [0, 0, 1], [0, 1, 1], [0, 0, 1], [1, 1, 1]],  # 3
    [[1, 0, 1], [1, 0, 1], [1, 1, 1], [0, 0, 1], [0, 0, 1]],  # 4
    [[1, 1, 1], [1, 0, 0], [1, 1, 1], [0, 0, 1], [1, 1, 1]],  # 5
    [[1, 1, 1], [1, 0, 0], [1, 1, 1], [1, 0, 1], [1, 1, 1]],  # 6
    [[1, 1, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1]],  # 7
    [[1, 1, 1], [1, 0, 1], [1, 1, 1], [1, 0, 1], [1, 1, 1]],  # 8
    [[1, 1, 1], [1, 0, 1], [1, 1, 1], [0, 0, 1], [1, 1, 1]],  # 9
], np.float32)


def images_to_grid(images: np.ndarray, height: int, width: int,
                   epoch: Optional[int] = None) -> np.ndarray:
    """Tile NHWC images row by row into a (height x width) grid; with
    ``epoch``, a 7-pixel strip below carries its digits."""
    images = np.asarray(images, np.float32)
    n, ih, iw, c = images.shape
    strip = 1 + 5 + 1 if epoch is not None else 0
    grid = imageops.assemble_grid(images, height, width, strip)
    if grid is None:  # the numpy path, without the C++ library
        grid = np.zeros((height * ih + strip, width * iw, c), np.float32)
        for i in range(min(n, height * width)):
            gy, gx = divmod(i, width)
            grid[gy * ih:(gy + 1) * ih, gx * iw:(gx + 1) * iw] = images[i]
    if epoch is not None:
        _stamp_epoch(grid, int(epoch))
    return grid


def _stamp_epoch(grid: np.ndarray, epoch: int):
    """nn_utils.lua:518-534: digits drawn right to left at the bottom
    right, 6 pixels apart."""
    h, w, _ = grid.shape
    for pos, ch in enumerate(reversed(str(epoch)), start=1):
        x0 = w - 1 - pos * 5 - pos
        if x0 < 0:
            break
        grid[h - 6:h - 1, x0:x0 + 3, :] = CHAR_TENSORS[int(ch)][..., None]


def add_border(image: np.ndarray, color: Sequence[float],
               thickness: int = 1) -> np.ndarray:
    """A copy of ``image`` with a coloured frame; grayscale images take the
    mean of ``color``."""
    img = np.array(image, np.float32, copy=True)
    c = np.asarray(color, np.float32)
    if img.shape[-1] == 1:
        c = np.array([float(np.mean(c))], np.float32)
    t = thickness
    img[:t, :, :] = c
    img[-t:, :, :] = c
    img[:, :t, :] = c
    img[:, -t:, :] = c
    return img


def save_image(path: str, image: np.ndarray):
    """Write a [0,1] float HWC (or HW1) image as PNG/JPG."""
    from PIL import Image
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.clip(np.asarray(image), 0.0, 1.0)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    arr = (arr * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(path)


def save_images_as_grid(path: str, images: np.ndarray, height: int,
                        width: int, epoch: Optional[int] = None):
    """nn_utils.saveImagesAsGrid (nn_utils.lua:544-548)."""
    save_image(path, images_to_grid(images, height, width, epoch))
