"""The weights and the real images the benchmark makes from ``--seed``, on
the card, and hands to both the program and the reference.

Weights follow the port's ``heuristic`` init (weight-init.lua's LeCun
scheme): every convolution and dense kernel uniform(-s, s) with s = sqrt(1
/ (3 fan_in)), biases 0, BatchNorm scales 1 and shifts 0 with running mean
0 and variance 1, PReLU slopes 0.25. One model's kernels come from one
``torch.rand`` draw on the card, cut into leaves. The leaves are named as
the port's modules and the JAX checkpoints name them (``l0.kernel``,
``l3.b1.l6.bias``, ...), kernels HWIO or (in, out).

Real images are the procedural faces of ``data/synthetic.py`` (a skin
oval, two eyes and a mouth as gaussian blobs, tinted, on a background,
with a little noise), drawn here with torch on the card.
"""
from __future__ import annotations

import math

import torch


def _conv(name, k, ci, co):
    return [(f"{name}.kernel", (k, k, ci, co), k * k * ci),
            (f"{name}.bias", (co,), 0)]


def _dense(name, i, o):
    return [(f"{name}.kernel", (i, o), i), (f"{name}.bias", (o,), 0)]


def _bn(name, c):
    return [(f"{name}.{leaf}", (c,), -1)
            for leaf in ("scale", "bias", "mean", "var")]


def _prelu(name):
    return [(f"{name}.alpha", (1,), -2)]


def g3_leaves(image, noise_dim):
    """(name, shape, fan_in) of G3's leaves; fan_in 0 marks a bias, -1 a
    BatchNorm leaf, -2 a PReLU slope."""
    c, h, w = image
    f = 512 * (h // 4) * (w // 4)
    return (_dense("l0", noise_dim, f) + _bn("l1", f)
            + _conv("l5", 3, 512, 256) + _bn("l6", 256)
            + _conv("l9", 3, 256, 128) + _bn("l10", 128)
            + _conv("l12", 3, 128, c))


def r_leaves(image, noise_dim):
    c, h, w = image
    out = []
    chans = ((c, 64), (64, 64), (64, 64), (64, 128), (128, 128), (128, 128))
    names = (("l0", "l1"), ("l4", "l5"), ("l8", "l9"), ("l13", "l14"),
             ("l17", "l18"), ("l21", "l22"))
    for (cv, bn), (ci, co) in zip(names, chans):
        out += _conv(cv, 3, ci, co) + _bn(bn, co)
    return (out + _dense("l27", 128 * (h // 4) * (w // 4), 512)
            + _bn("l28", 512) + _dense("l31", 512, noise_dim))


def d2_leaves(image):
    c, h, w = image

    def nxn(pre, k, ci, co):
        return _conv(f"{pre}.l0", k, ci, co) + _prelu(f"{pre}.l1")

    return (nxn("l0", 3, c, 128) + nxn("l1", 3, 128, 128)
            + nxn("l3.b0.l0", 5, 128, 64)
            + _dense("l3.b0.l3", 64 * (h // 4) * (w // 4), 512)
            + _prelu("l3.b0.l4")
            + nxn("l3.b1.l0", 3, 128, 128) + nxn("l3.b1.l2", 3, 128, 256)
            + nxn("l3.b1.l3", 3, 256, 256)
            + _dense("l3.b1.l6", 256 * (h // 8) * (w // 8), 512)
            + _prelu("l3.b1.l7") + _dense("l4", 1024, 256) + _prelu("l5")
            + _dense("l7", 256, 1))


def make(leaves, gen: torch.Generator, device) -> dict:
    """{name: f32 tensor} for ``leaves``: every kernel from one uniform
    draw, scaled to its own half-width."""
    kernels = [(n, s, fan) for n, s, fan in leaves if fan > 0]
    total = sum(math.prod(s) for _, s, _ in kernels)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for n, s, fan in leaves:
        if fan > 0:
            size = math.prod(s)
            out[n] = u[at:at + size].view(s) * math.sqrt(1.0 / (3.0 * fan))
            at += size
        else:
            fill = {0: 0.0, -2: 0.25}.get(fan)
            if fill is None:  # BatchNorm: scale and var 1, bias and mean 0
                fill = 1.0 if n.endswith((".scale", ".var")) else 0.0
            out[n] = torch.full(s, fill, device=device)
    return out


def nested(flat: dict) -> dict:
    """The ``{"params", "state"}`` tree of a flat dict: BatchNorm running
    statistics under ``state``, every other leaf under ``params``, nested
    by the dots of the names."""
    tree = {"params": {}, "state": {}}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree["state" if leaf in ("mean", "var") else "params"]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def faces(n: int, height: int, width: int, gen: torch.Generator,
          device) -> torch.Tensor:
    """(n, height, width, 3) f32 RGB in [0, 1]: ``data/synthetic.py``'s
    recipe, drawn with torch."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (n,), generator=gen,
                                           device=device)

    yy = ((torch.arange(height, device=device) + 0.5) / height * 2 - 1)
    xx = ((torch.arange(width, device=device) + 0.5) / width * 2 - 1)
    yy, xx = yy[None, :, None], xx[None, None, :]

    def blob(cy, cx, sy, sx):
        dy = (yy - cy[:, None, None]) / sy[:, None, None]
        dx = (xx - cx[:, None, None]) / sx[:, None, None]
        return torch.exp(-(dy * dy + dx * dx))

    cy, cx = u(-0.15, 0.15), u(-0.15, 0.15)
    oval = blob(cy, cx, u(0.55, 0.8), u(0.4, 0.6))
    eye_dy, eye_dx, eye_s = u(-0.35, -0.15), u(0.2, 0.35), u(0.06, 0.12)
    eyes = (blob(cy + eye_dy, cx - eye_dx, eye_s, eye_s)
            + blob(cy + eye_dy, cx + eye_dx, eye_s, eye_s))
    mouth = blob(cy + u(0.3, 0.5), cx + u(-0.05, 0.05), u(0.05, 0.1),
                 u(0.15, 0.3))
    skin = u(0.45, 0.9, n, 1, 1, 3)
    skin[..., 2] *= 0.8
    bg = u(0.0, 0.35, n, 1, 1, 3)
    base = bg + (skin - bg) * oval[..., None]
    dark = (eyes + 0.8 * mouth).clamp(0.0, 1.0)[..., None]
    img = base * (1.0 - 0.85 * dark)
    noise = 0.02 * torch.randn(img.shape, generator=gen, device=device)
    return (img + noise).clamp(0.0, 1.0)
