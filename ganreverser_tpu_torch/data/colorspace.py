"""Colour-space conversions — the counterpart of
ganreverser_tpu/data/colorspace.py (utils/nn_utils.lua:133-246), over whole
NHWC batches on the host.

* ``y``  — the reference's custom grayscale weights 0.21/0.72/0.07
           (nn_utils.lua:237-239);
* ``yuv`` — torch image.rgb2yuv / yuv2rgb matrices;
* ``hsl`` — torch image.rgb2hsl / hsl2rgb formulas, h/s/l all in [0, 1].

As in the JAX package, ``rgb_to_colorspace`` and ``to_rgb`` take the C++
versions of ``y`` and ``yuv`` (native/imageops.cc) where the library is
built, and the numpy functions below otherwise; the two sum in another
order (within 1e-5, tests/test_torch_port_native.py).
"""
from __future__ import annotations

import numpy as np

from ..native import imageops

COLOR_SPACES = ("rgb", "y", "yuv", "hsl")

_YUV_FROM_RGB = np.array([
    [0.299, 0.587, 0.114],
    [-0.14713, -0.28886, 0.436],
    [0.615, -0.51499, -0.10001],
], np.float32)

_RGB_FROM_YUV = np.array([
    [1.0, 0.0, 1.13983],
    [1.0, -0.39465, -0.58060],
    [1.0, 2.03211, 0.0],
], np.float32)


def rgb2y(images: np.ndarray) -> np.ndarray:
    """nn_utils.rgb2y (nn_utils.lua:221-246): 0.21 r + 0.72 g + 0.07 b."""
    y = (0.21 * images[..., 0] + 0.72 * images[..., 1]
         + 0.07 * images[..., 2])[..., None]
    return y.astype(np.float32)


def rgb2yuv(images: np.ndarray) -> np.ndarray:
    return (images @ _YUV_FROM_RGB.T).astype(np.float32)


def yuv2rgb(images: np.ndarray) -> np.ndarray:
    return (images @ _RGB_FROM_YUV.T).astype(np.float32)


def _native_or(fn_native, fn_numpy, images: np.ndarray) -> np.ndarray:
    """The C++ image op where the library is built, else numpy."""
    out = fn_native(images)
    return out if out is not None else fn_numpy(images)


def rgb2hsl(images: np.ndarray) -> np.ndarray:
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    mx = np.max(images, axis=-1)
    mn = np.min(images, axis=-1)
    l = (mx + mn) / 2.0
    c = mx - mn
    safe_c = np.where(c == 0, 1.0, c)
    hr = np.mod((g - b) / safe_c, 6.0)
    hg = (b - r) / safe_c + 2.0
    hb = (r - g) / safe_c + 4.0
    h = np.where(mx == r, hr, np.where(mx == g, hg, hb)) / 6.0
    h = np.where(c == 0, 0.0, h)
    denom = 1.0 - np.abs(2.0 * l - 1.0)
    s = np.where(c == 0, 0.0, c / np.where(denom == 0, 1.0, denom))
    return np.stack([h, s, l], axis=-1).astype(np.float32)


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


def rgb_to_colorspace(images: np.ndarray, colorspace: str) -> np.ndarray:
    """NN_UTILS.rgbToColorSpace (nn_utils.lua:191-217): NHWC RGB in, NHWC
    out (C = 1 for 'y')."""
    if colorspace == "rgb":
        return images
    if colorspace == "y":
        return _native_or(imageops.rgb2y_native, rgb2y, images)
    if colorspace == "yuv":
        return _native_or(imageops.rgb2yuv_native, rgb2yuv, images)
    if colorspace == "hsl":
        return rgb2hsl(images)
    raise ValueError(f"Unknown color space {colorspace!r}")


def to_rgb(images: np.ndarray, colorspace: str) -> np.ndarray:
    """NN_UTILS.toRgb (nn_utils.lua:146-167): NHWC images in
    ``colorspace`` (C = 1 for 'y') -> NHWC RGB."""
    if colorspace == "rgb":
        return images
    if colorspace == "y":
        return np.repeat(images, 3, axis=-1)
    if colorspace == "yuv":
        return _native_or(imageops.yuv2rgb_native, yuv2rgb, images)
    if colorspace == "hsl":
        return hsl2rgb(images)
    raise ValueError(f"Unknown color space {colorspace!r}")


def switch_colorspace(images: np.ndarray, src: str, dst: str) -> np.ndarray:
    """NN_UTILS.switchColorSpace (nn_utils.lua:133-137): ``src`` -> RGB ->
    ``dst``; distillation across colour spaces uses it
    (pretrain_with_previous_net.lua:167,182)."""
    return rgb_to_colorspace(to_rgb(images, src), dst)
