"""Weight initialisation — the schemes of weight-init.lua, and the torch
default resets the reference actually leaves in place, as
ganreverser_tpu/models/init.py has them.

Each scheme gives the half-width ``std`` of a uniform(-std, std) draw, as
torch's ``m:reset(std)`` does (weight-init.lua:40-75). Fans
(weight-init.lua:54-65): a conv's fan_in is in_ch*kh*kw and its fan_out
out_ch*kh*kw; a dense layer's are its in and out features. Biases are zero
unless ``zero_bias=False``, which draws them from the same uniform (torch's
default reset of layers the reference's w_init never reaches; see
models/zoo.py for which those are under ``init="torch"``).

The draws come from an explicit ``torch.Generator`` on the tensor's
device, weight first, then the bias where it is drawn. They match the JAX
package in distribution only: ``jax.random`` streams cannot be reproduced.
"""
from __future__ import annotations

import math

import torch

SCHEMES = ("heuristic", "xavier", "xavier_caffe", "kaiming", "torch_default")


def scheme_std(scheme: str, fan_in: int, fan_out: int) -> float:
    if scheme == "heuristic":      # LeCun'98 "Efficient backprop" (l.14-16)
        return math.sqrt(1.0 / (3.0 * fan_in))
    if scheme == "xavier":         # Glorot 2010 (l.21-23)
        return math.sqrt(2.0 / (fan_in + fan_out))
    if scheme == "xavier_caffe":   # (l.28-30)
        return math.sqrt(1.0 / fan_in)
    if scheme == "kaiming":        # He 2015 (l.35-37)
        return math.sqrt(4.0 / (fan_in + fan_out))
    if scheme == "torch_default":  # torch nn reset(): 1/sqrt(fan_in)
        return math.sqrt(1.0 / fan_in)
    raise ValueError(f"Unknown init scheme {scheme!r}")


@torch.no_grad()
def _draw_(kernel: torch.Tensor, bias: torch.Tensor, std: float,
           generator: torch.Generator, zero_bias: bool) -> None:
    kernel.uniform_(-std, std, generator=generator)
    if zero_bias:
        bias.zero_()
    else:
        bias.uniform_(-std, std, generator=generator)


def init_dense(kernel: torch.Tensor, bias: torch.Tensor,
               generator: torch.Generator, scheme: str = "heuristic",
               zero_bias: bool = True) -> None:
    """Fill a dense layer's (in, out) ``kernel`` and its ``bias`` in place."""
    fan_in, fan_out = kernel.shape
    _draw_(kernel, bias, scheme_std(scheme, fan_in, fan_out), generator,
           zero_bias)


def init_conv(kernel: torch.Tensor, bias: torch.Tensor,
              generator: torch.Generator, scheme: str = "heuristic",
              zero_bias: bool = True) -> None:
    """Fill a conv's HWIO ``kernel`` and its ``bias`` in place."""
    kh, kw, in_ch, out_ch = kernel.shape
    _draw_(kernel, bias, scheme_std(scheme, in_ch * kh * kw,
                                    out_ch * kh * kw), generator, zero_bias)


@torch.no_grad()
def init_bn_scale(scale: torch.Tensor, generator: torch.Generator,
                  scale_init: str = "ones") -> None:
    """A BatchNorm scale: ones, or uniform(0, 1) under ``"torch"`` (the
    old-torch nn.BatchNormalization:reset())."""
    if scale_init == "torch":
        scale.uniform_(0.0, 1.0, generator=generator)
    elif scale_init == "ones":
        scale.fill_(1.0)
    else:
        raise ValueError(f"Unknown BatchNorm scale init {scale_init!r}")
