"""Colour space to RGB for rendering — the numpy path of
ganreverser_tpu/data/colorspace.py::to_rgb (nn_utils.lua:146-167)."""
from __future__ import annotations

import numpy as np

_RGB_FROM_YUV = np.array([
    [1.0, 0.0, 1.13983],
    [1.0, -0.39465, -0.58060],
    [1.0, 2.03211, 0.0],
], np.float32)


def yuv2rgb(images: np.ndarray) -> np.ndarray:
    return (images @ _RGB_FROM_YUV.T).astype(np.float32)


def hsl2rgb(images: np.ndarray) -> np.ndarray:
    h, s, l = images[..., 0], images[..., 1], images[..., 2]
    c = (1.0 - np.abs(2.0 * l - 1.0)) * s
    hp = h * 6.0
    x = c * (1.0 - np.abs(np.mod(hp, 2.0) - 1.0))
    z = np.zeros_like(c)
    conds = [
        (hp < 1, (c, x, z)), ((hp >= 1) & (hp < 2), (x, c, z)),
        ((hp >= 2) & (hp < 3), (z, c, x)), ((hp >= 3) & (hp < 4), (z, x, c)),
        ((hp >= 4) & (hp < 5), (x, z, c)), (hp >= 5, (c, z, x)),
    ]
    r = np.zeros_like(c)
    g = np.zeros_like(c)
    b = np.zeros_like(c)
    for cond, (rr, gg, bb) in conds:
        r = np.where(cond, rr, r)
        g = np.where(cond, gg, g)
        b = np.where(cond, bb, b)
    m = l - c / 2.0
    return np.stack([r + m, g + m, b + m], axis=-1).astype(np.float32)


def to_rgb(images: np.ndarray, colorspace: str) -> np.ndarray:
    """NHWC images in ``colorspace`` (C=1 for 'y') -> NHWC RGB."""
    if colorspace == "rgb":
        return images
    if colorspace == "y":
        return np.repeat(images, 3, axis=-1)
    if colorspace == "yuv":
        return yuv2rgb(images)
    if colorspace == "hsl":
        return hsl2rgb(images)
    raise ValueError(f"Unknown color space {colorspace!r}")
