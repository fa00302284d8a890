"""Kernel B6: one 3x3 SAME conv + per-channel scale/shift + activation
(relu, elu, prelu or none) + an optional 2x2 maxpool, and the eval-mode
BatchNorm folding of ganreverser_tpu/ops/conv_kernel.py.

``conv3x3_bn_act`` is the counterpart of that module's Pallas kernel, the
D/R conv + PReLU + pool block: D2's evaluation forward runs five of its six
convolutions on it (models/fastpath.py::make_fast_discriminator). On CUDA
tensors it launches the single-layer kernel of ``csrc/conv_block.cu`` (the
one kernel B chains) with the PReLU epilogue; on CPU tensors it takes the
plain version ``conv3x3_bn_act_plain``; no other device is accepted.
``conv3x3_bn_act.launches`` counts its launches, apart from kernel B's.

Semantics kept from the TPU kernel: the product accumulates in f32, then
``y * scale + shift``, the activation (PReLU ``y >= 0 ? y : alpha * y``
with an f32 slope; ELU ``exp(min(y, 0)) - 1``), the optional pool, and one
rounding to ``x.dtype``. The PReLU slope may be a tensor of one f32 on the
device, which the kernel reads from device memory, so a learned slope costs
no host sync.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

_ACTS = ("relu", "elu", "prelu", "none")


def fold_batchnorm(bn_params: dict, bn_state: dict, conv_bias: torch.Tensor,
                   eps: float = 1e-5):
    """Fold conv bias + eval-mode BN into per-channel f32 (scale, shift):
    y = (conv + bias - mean) * g / sqrt(var + eps) + b."""
    g = bn_params["scale"].float()
    b = bn_params["bias"].float()
    mean = bn_state["mean"].float()
    var = bn_state["var"].float()
    scale = g * torch.rsqrt(var + eps)
    shift = (conv_bias.float() - mean) * scale + b
    return scale, shift


def _check_args(x: torch.Tensor, act: str, pool: bool) -> None:
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    h, w = x.shape[1:3]
    if pool and (h % 2 or w % 2):
        raise ValueError(f"pool needs even H and W, got {h}x{w}")


def conv3x3_bn_act_plain(x: torch.Tensor, kernel: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor, *,
                         act: str = "relu", prelu_alpha=0.25,
                         pool: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: an f32 conv of
    the ``x.dtype``-rounded operands, the epilogue in f32, the optional
    pool, one rounding to ``x.dtype``."""
    _check_args(x, act, pool)
    wt = kernel.to(x.dtype).float().permute(3, 2, 0, 1)
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), wt, padding=1)
    y = acc.permute(0, 2, 3, 1) * scale.float() + shift.float()
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "elu":
        y = torch.where(y > 0, y, torch.exp(torch.clamp_max(y, 0.0)) - 1.0)
    elif act == "prelu":
        a = torch.as_tensor(prelu_alpha, dtype=torch.float32,
                            device=y.device).reshape(())
        y = torch.where(y >= 0, y, a * y)
    if pool:
        n, h, w, c = y.shape
        y = y.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    return y.to(x.dtype)


def conv3x3_bn_act(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, *, act: str = "relu",
                   prelu_alpha=0.25, pool: bool = False) -> torch.Tensor:
    """x: (N,H,W,Ci) NHWC, f32 or bf16, any N; kernel: (3,3,Ci,Co) HWIO;
    scale/shift: (Co,) (fold_batchnorm's, or ones and the conv bias);
    ``prelu_alpha``: the PReLU slope, a float or a one-element tensor.
    Returns (N,H,W,Co), or (N,H/2,W/2,Co) with ``pool``, in ``x.dtype``."""
    _check_args(x, act, pool)
    alpha = (prelu_alpha if isinstance(prelu_alpha, torch.Tensor)
             else torch.full((1,), float(prelu_alpha), device=x.device))
    if cuda_lib.dispatch_device(x, kernel, scale, shift, alpha) == "cpu":
        return conv3x3_bn_act_plain(x, kernel, scale, shift, act=act,
                                    prelu_alpha=alpha, pool=pool)
    n, h, w, ci = x.shape
    co = kernel.shape[-1]
    w9 = kernel.to(x.dtype).reshape(9, ci, co).contiguous()
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    alpha = alpha.float().reshape(1).contiguous()
    cuda_lib.require(x, "x", x.device, x.dtype, (n, h, w, ci))
    cuda_lib.require(w9, "kernel", x.device, x.dtype, (9, ci, co))
    cuda_lib.require(scale, "scale", x.device, torch.float32, (co,))
    cuda_lib.require(shift, "shift", x.device, torch.float32, (co,))
    cuda_lib.require(alpha, "prelu_alpha", x.device, torch.float32, (1,))
    oh, ow = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((n, oh, ow, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = cuda_lib.library().gr_conv3x3_bn_act(
            cuda_lib.dtype_code(x), x.data_ptr(), w9.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), alpha.data_ptr(),
            out.data_ptr(), n, h, w, ci, co, cuda_lib.ACT_CODES[act],
            int(pool), cuda_lib.stream_of(x))
    cuda_lib.check(rc, "conv3x3_bn_act")
    conv3x3_bn_act.launches += 1
    return out


conv3x3_bn_act.launches = 0
