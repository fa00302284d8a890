"""Image grids, borders and saving — the numpy path of
ganreverser_tpu/utils/grids.py (nn_utils.lua:429-548). The epoch stamp and
the C++ grid assembly are not ported yet."""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

BLUE = (0.0, 0.0, 1.0)   # similarity needle (apply_r.lua:281-296)
RED = (1.0, 0.0, 0.0)    # anomaly (apply_r.lua:376-388)


def images_to_grid(images: np.ndarray, height: int, width: int) -> np.ndarray:
    """Tile NHWC images row by row into a (height x width) grid."""
    images = np.asarray(images, np.float32)
    n, ih, iw, c = images.shape
    grid = np.zeros((height * ih, width * iw, c), np.float32)
    for i in range(min(n, height * width)):
        gy, gx = divmod(i, width)
        grid[gy * ih:(gy + 1) * ih, gx * iw:(gx + 1) * iw] = images[i]
    return grid


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
