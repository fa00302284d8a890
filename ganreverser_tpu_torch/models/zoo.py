"""G3, D2 and R — the counterparts of ganreverser_tpu/models/zoo.py's
``create_G3``, ``create_D2`` and ``create_R_default`` (plain and fixer),
with the same layer indices.

``dimensions`` is (C, H, W) as in the reference; tensors flow as NHWC. The
models are returned in evaluation mode (``.train()`` switches BatchNorm and
the dropouts to training); their weights are zero until loaded
(``models/bridge.py``) or drawn with ``modules.init_parameters``, which
ports the JAX package's default ``init="heuristic"`` only (its ``torch``,
``xavier`` and ``kaiming`` schemes are not ported). G4, D_default,
D_facegen and createResidual come later.
"""
from __future__ import annotations

import torch

from .modules import (Activation, BatchNorm, ConcatBranches, Conv, Dense,
                      Dropout, Flatten, Identity, MaxPool, PReLU, Reshape,
                      Sequential, SpatialDropout, UpsampleConv)

Dims = tuple  # (C, H, W)


def create_G(dimensions: Dims, noise_dim: int,
             dtype: torch.dtype = torch.float32):
    """models.create_G == create_G3 (models.lua:201-203)."""
    return create_G3(dimensions, noise_dim, dtype)


def create_G3(dimensions: Dims, noise_dim: int,
              dtype: torch.dtype = torch.float32):
    """create_G3 (models.lua:104-143): z -> Linear -> BN -> ReLU -> reshape
    H/4 x W/4 x 512 -> 2x [NN-upsample x2 + 3x3 conv + BN + ReLU] -> 3x3 conv
    -> Sigmoid. Each upsample+conv pair is one UpsampleConv after an
    Identity, the layer indices of the JAX package's fused G (its checkpoint
    keys are the same fused or not)."""
    c, h, w = dimensions
    sh, sw = h // 4, w // 4
    return Sequential([
        Dense(noise_dim, 512 * sh * sw, dtype=dtype),
        BatchNorm(512 * sh * sw, dtype=dtype),
        Activation("relu"),
        Reshape((sh, sw, 512)),
        Identity(), UpsampleConv(512, 256, dtype=dtype),
        BatchNorm(256, dtype=dtype),
        Activation("relu"),
        Identity(), UpsampleConv(256, 128, dtype=dtype),
        BatchNorm(128, dtype=dtype),
        Activation("relu"),
        Conv(128, c, dtype=dtype),
        Activation("sigmoid"),
    ]).eval()


def create_D(dimensions: Dims, dtype: torch.dtype = torch.float32,
             init: str = "heuristic"):
    """models.create_D == create_D2 (models.lua:209-211)."""
    return create_D2(dimensions, dtype, init)


def _nxn(in_ch: int, features: int, kernel: int, dropout: float, dtype):
    """create_D2's createNxN helper (models.lua:273-281): conv + PReLU, and
    a SpatialDropout when ``dropout`` > 0. Reference quirk kept: the
    argument only gates whether the dropout is added; its rate is always
    0.25."""
    layers = [Conv(in_ch, features, dtype=dtype, kernel=kernel), PReLU()]
    if dropout > 0:
        layers.append(SpatialDropout(0.25))
    return Sequential(layers)


def create_D2(dimensions: Dims, dtype: torch.dtype = torch.float32,
              init: str = "heuristic"):
    """create_D2 (models.lua:272-337): a stem of two 3x3 conv + PReLU
    blocks and a pool, then two branches concatenated on features (left: a
    5x5 conv path; right: a deeper 3x3 path), each ending in Dense 512 +
    PReLU, then Dense 256 + PReLU + Dropout and Dense 1 + Sigmoid. H and W
    must be divisible by 8. Set the dropouts' generator
    (``modules.set_dropout_generator``) before a training forward."""
    if init != "heuristic":
        raise ValueError(f"init {init!r} is not ported: the port draws the "
                         "'heuristic' scheme only (models/init.py of the JAX "
                         "package holds the others)")
    c, h, w = dimensions
    if h % 8 or w % 8:
        raise ValueError(f"D2 needs H and W divisible by 8, got {h}x{w}")
    left = Sequential([
        _nxn(128, 64, 5, 0.2, dtype),
        MaxPool(),
        Flatten(),
        Dense(64 * (h // 4) * (w // 4), 512, dtype=dtype),
        PReLU(),
        Dropout(0.25),
    ])
    right = Sequential([
        _nxn(128, 128, 3, 0.2, dtype),
        MaxPool(),
        _nxn(128, 256, 3, 0.2, dtype),
        _nxn(256, 256, 3, 0.2, dtype),
        MaxPool(),
        Flatten(),
        Dense(256 * (h // 8) * (w // 8), 512, dtype=dtype),
        PReLU(),
    ])
    return Sequential([
        _nxn(c, 128, 3, 0.0, dtype),
        _nxn(128, 128, 3, 0.2, dtype),
        MaxPool(),
        ConcatBranches([left, right]),
        Dense(1024, 256, dtype=dtype),
        PReLU(),
        Dropout(0.25),
        Dense(256, 1, dtype=dtype),
        Activation("sigmoid"),
    ]).eval()


def create_R(dimensions: Dims, noise_dim: int, noise_method: str,
             fixer: bool = False, dtype: torch.dtype = torch.float32,
             dropout_impl: str = "plain"):
    """models.create_R == create_R_default (models.lua:385-387)."""
    return create_R_default(dimensions, noise_dim, noise_method, fixer, dtype,
                            dropout_impl)


def create_R_default(dimensions: Dims, noise_dim: int, noise_method: str,
                     fixer: bool = False,
                     dtype: torch.dtype = torch.float32,
                     dropout_impl: str = "plain"):
    """create_R_default (models.lua:389-464): 3x [conv64 + BN + ELU] + pool,
    3x [conv128 + BN + ELU] + pool, Dense 512 + BN + ELU, Dense noise_dim,
    and a Tanh head only for uniform noise. ``fixer=True`` prepends the
    always-on Dropout(0.5) (models.lua:399-406), which shifts every layer
    index by one. The seven element dropouts and the fixer's take
    ``dropout_impl`` (``plain`` Bernoulli masks or ``kernel`` B5); the
    SpatialDropout always draws a plain mask. Set the dropouts' generator
    (``modules.set_dropout_generator``) before an active forward."""
    if noise_method not in ("normal", "uniform"):
        raise ValueError(noise_method)
    c, h, w = dimensions

    def block(in_ch, feat):
        return [Conv(in_ch, feat, dtype=dtype), BatchNorm(feat, dtype=dtype),
                Activation("elu")]

    def drop():  # nn.Dropout() default 0.5
        return Dropout(0.5, impl=dropout_impl)

    layers = [Dropout(0.5, always_on=True, impl=dropout_impl)] if fixer else []
    layers += [
        *block(c, 64), drop(),
        *block(64, 64), drop(),
        *block(64, 64), MaxPool(), drop(),
        *block(64, 128), drop(),
        *block(128, 128), drop(),
        *block(128, 128), SpatialDropout(0.25), MaxPool(),
        Flatten(),
        Dense(128 * (h // 4) * (w // 4), 512, dtype=dtype),
        BatchNorm(512, dtype=dtype), Activation("elu"),
        drop(),
        Dense(512, noise_dim, dtype=dtype),
    ]
    if noise_method != "normal":
        layers.append(Activation("tanh"))
    return Sequential(layers).eval()
