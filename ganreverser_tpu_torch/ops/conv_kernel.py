"""Kernel B6: one 3x3 SAME conv + per-channel scale/shift + activation
(relu, elu, prelu or none) + an optional 2x2 maxpool, and the eval-mode
BatchNorm folding of ganreverser_tpu/ops/conv_kernel.py.

``conv3x3_bn_act`` is the counterpart of that module's Pallas kernel, the
D/R conv + PReLU + pool block: D2's evaluation forward runs five of its six
convolutions on it (models/fastpath.py::make_fast_discriminator). On CUDA
tensors it launches the single-layer kernel of ``csrc/conv_block.cu`` (the
one kernel B chains, :func:`launch_conv3x3`) with the PReLU epilogue: bf16
on the tensor cores, f32 on the CUDA cores; on CPU tensors it takes the
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

from . import conv_operands, cuda_lib

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
    out = launch_conv3x3(x, kernel, scale, shift, act=act,
                         alpha=alpha.float().reshape(1), pool=pool,
                         name="conv3x3_bn_act")
    conv3x3_bn_act.launches += 1
    return out


cuda_lib.counted(conv3x3_bn_act)


def conv3x3_operand(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A (3,3,Ci,Co) HWIO kernel as :func:`launch_conv3x3` hands it to the
    kernel in ``dtype``: bf16 the tensor-core tile's (9, Co, Ci'), padded
    and K-major (``conv_operands.conv3x3_weights``); f32 (9, Ci, Co). A
    caller that runs the same weights many times lays them out once."""
    if dtype == torch.bfloat16:
        return conv_operands.conv3x3_weights(kernel, dtype)
    ci, co = kernel.shape[2:]
    return kernel.to(dtype).reshape(9, ci, co).contiguous()


def launch_conv3x3(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, *, act: str, alpha=None,
                   pool: bool = False, name: str,
                   operand: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of ``csrc/conv_block.cu``'s ``gr_conv3x3_bn_act`` on CUDA
    tensors, for kernels B and B6 (each wrapper counts its own). bf16 runs
    on the tensor-core tile with the padded, K-major operands of
    ``conv_operands`` and its ``tile_plan``; f32 on the CUDA-core tile with
    (9, Ci, Co) weights. ``alpha``: the PReLU slope, a (1,) f32 tensor on
    the device, or None where ``act`` is not prelu. ``operand``: the
    weights already laid out by :func:`conv3x3_operand` (else laid out
    here, on every call)."""
    code = cuda_lib.dtype_code(x)
    n, h, w, ci = x.shape
    co = kernel.shape[-1]
    if tuple(kernel.shape[:3]) != (3, 3, ci):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not take "
                         f"the input's {ci} channels")
    wk = conv3x3_operand(kernel, x.dtype) if operand is None else operand
    if x.dtype == torch.bfloat16:
        xk = conv_operands.pad_channels(x)
        plan = conv_operands.tile_plan(h, w, ci, co)
        wshape = (9, co, xk.shape[-1])
    else:
        xk, plan = x, conv_operands.NO_PLAN
        wshape = (9, ci, co)
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    cuda_lib.require(xk, "x", x.device, x.dtype, (n, h, w, xk.shape[-1]))
    cuda_lib.require(wk, "kernel", x.device, x.dtype, wshape)
    cuda_lib.require(scale, "scale", x.device, torch.float32, (co,))
    cuda_lib.require(shift, "shift", x.device, torch.float32, (co,))
    if alpha is not None:
        alpha = alpha.contiguous()
        cuda_lib.require(alpha, "prelu_alpha", x.device, torch.float32, (1,))
    oh, ow = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((n, oh, ow, co), dtype=x.dtype, device=x.device)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_conv3x3_bn_act(
            code, xk.data_ptr(), wk.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), None if alpha is None else alpha.data_ptr(),
            out.data_ptr(), n, h, w, xk.shape[-1], co,
            cuda_lib.ACT_CODES[act], int(pool), *plan, cuda_lib.stream_of(x))
    cuda_lib.check(rc, name)
    return out
