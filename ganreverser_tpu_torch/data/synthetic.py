"""Procedural face-like images so every pipeline (training, inversion,
tests) runs without a real dataset — a copy of
ganreverser_tpu/data/synthetic.py, which the port may not import (its
package pulls in JAX); for one seed both give the same arrays, bit for bit.
No reference equivalent: the reference requires a directory of JPEG face
crops (README.md:95-101).

Faces are built from smooth gaussian blobs: skin oval, two eyes, mouth,
per-face randomized geometry/colors — enough structure for a GAN/Reverser
pipeline to have learnable signal.
"""
from __future__ import annotations

import numpy as np


def synthetic_faces(n: int, height: int, width: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Returns (n, height, width, 3) float32 RGB in [0, 1]."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    yy = (yy + 0.5) / height * 2.0 - 1.0   # [-1, 1]
    xx = (xx + 0.5) / width * 2.0 - 1.0

    def blob(cy, cx, sy, sx):
        # (n, h, w) gaussian per face
        dy = (yy[None] - cy[:, None, None]) / sy[:, None, None]
        dx = (xx[None] - cx[:, None, None]) / sx[:, None, None]
        return np.exp(-(dy * dy + dx * dx))

    # face oval
    cy = rng.uniform(-0.15, 0.15, n).astype(np.float32)
    cx = rng.uniform(-0.15, 0.15, n).astype(np.float32)
    oval = blob(cy, cx, rng.uniform(0.55, 0.8, n).astype(np.float32),
                rng.uniform(0.4, 0.6, n).astype(np.float32))
    # eyes (dark), mirrored around face center
    eye_dy = rng.uniform(-0.35, -0.15, n).astype(np.float32)
    eye_dx = rng.uniform(0.2, 0.35, n).astype(np.float32)
    eye_s = rng.uniform(0.06, 0.12, n).astype(np.float32)
    eye_l = blob(cy + eye_dy, cx - eye_dx, eye_s, eye_s)
    eye_r = blob(cy + eye_dy, cx + eye_dx, eye_s, eye_s)
    # mouth (dark, wide)
    mouth = blob(cy + rng.uniform(0.3, 0.5, n).astype(np.float32),
                 cx + rng.uniform(-0.05, 0.05, n).astype(np.float32),
                 rng.uniform(0.05, 0.1, n).astype(np.float32),
                 rng.uniform(0.15, 0.3, n).astype(np.float32))

    skin = rng.uniform(0.45, 0.9, (n, 1, 1, 3)).astype(np.float32)
    skin[..., 2] *= 0.8  # warmer tint
    bg = rng.uniform(0.0, 0.35, (n, 1, 1, 3)).astype(np.float32)

    base = bg + (skin - bg) * oval[..., None]
    dark = np.clip(eye_l + eye_r + 0.8 * mouth, 0.0, 1.0)[..., None]
    img = base * (1.0 - 0.85 * dark)
    noise = rng.normal(0.0, 0.02, img.shape).astype(np.float32)
    return np.clip(img + noise, 0.0, 1.0).astype(np.float32)
