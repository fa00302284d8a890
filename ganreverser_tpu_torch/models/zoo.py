"""G3 and R — the counterparts of ganreverser_tpu/models/zoo.py's
``create_G3`` and ``create_R_default`` (plain and fixer), with the same
layer indices.

``dimensions`` is (C, H, W) as in the reference; tensors flow as NHWC. The
models are returned in evaluation mode (``.train()`` switches BatchNorm and
the dropouts to training); their weights are zero until loaded
(``models/bridge.py``) or drawn with ``modules.init_parameters``. D and the
other variants come later.
"""
from __future__ import annotations

import torch

from .modules import (Activation, BatchNorm, Conv, Dense, Dropout, Flatten,
                      Identity, MaxPool, Reshape, Sequential, SpatialDropout,
                      UpsampleConv)

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
