"""Kernel B8: kernel U with each phase's four taps stacked on the reduction
axis — the counterpart of benchmarks/tpu_upsample_v2.py's ``upsample_v2``
(one deeper dot per phase instead of four, a variant that never compiled on
the TPU).

``upsample_v2(x, kernel, scale, shift)`` computes what
``upsample2_conv3x3_bn_act(..., act="relu")`` computes, from the per-phase
channel-stacked weights of :func:`stacked_phase_kernels` (4, 4*Ci, Co). On
CUDA tensors it launches ``csrc/upsample_v2.cu`` (one K loop of 4*Ci per
phase): bf16 on the tensor-core tile, the weights laid out K-major by
``conv_operands.stacked_kmajor``, f32 on the CUDA cores; on CPU tensors it
takes :func:`upsample_v2_plain`.
``upsample_v2.launches`` counts the launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import conv_operands, cuda_lib
from .upsample_conv_kernel import phase_kernels


def stacked_phase_kernels(kernel: torch.Tensor) -> torch.Tensor:
    """(3,3,Ci,Co) -> (4, 4*Ci, Co) f32: phase a*2+b holds the phase
    kernels of taps (0,0), (0,1), (1,0), (1,1) one above the other, summed
    in f32 from the f32 kernel, as the TPU variant stacks them."""
    pk = phase_kernels(kernel.float())  # [a, ta, b, tb, Ci, Co]
    ci, co = kernel.shape[2], kernel.shape[3]
    return pk.permute(0, 2, 1, 3, 4, 5).reshape(4, 4 * ci, co)


def upsample_v2_plain(x, kernel, scale, shift) -> torch.Tensor:
    """Plain PyTorch version on any device: per phase the 2x2 conv with the
    stacked weights (rounded to ``x.dtype``) read back as taps, f32 sums,
    scale/shift and ReLU in f32, output rounded to ``x.dtype``."""
    n, h, w, _ = x.shape
    ci, co = kernel.shape[2], kernel.shape[3]
    k4 = stacked_phase_kernels(kernel).to(x.dtype).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = torch.empty((n, h, 2, w, 2, co), dtype=torch.float32,
                      device=x.device)
    for a in (0, 1):
        for b in (0, 1):
            wt = k4[a * 2 + b].reshape(2, 2, ci, co).permute(3, 2, 0, 1)
            y = F.conv2d(xp[:, a:a + h + 1, b:b + w + 1].permute(0, 3, 1, 2),
                         wt)
            out[:, :, a, :, b] = y.permute(0, 2, 3, 1)
    y = out.reshape(n, 2 * h, 2 * w, co) * scale.float() + shift.float()
    return torch.clamp_min(y, 0.0).to(x.dtype)


def upsample_v2(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """x: (N,H,W,Ci) NHWC; kernel: (3,3,Ci,Co) HWIO; scale/shift (Co,).
    Returns (N,2H,2W,Co) in ``x.dtype``, ReLU in the epilogue."""
    if cuda_lib.dispatch_device(x, kernel, scale, shift) == "cpu":
        return upsample_v2_plain(x, kernel, scale, shift)
    code = cuda_lib.dtype_code(x)
    n, h, w, ci = x.shape
    co = kernel.shape[-1]
    k4 = stacked_phase_kernels(kernel)
    if x.dtype == torch.bfloat16:  # the tensor-core tile's operands
        xk = conv_operands.pad_channels(x)
        plan = conv_operands.tile_plan(h, w, ci, co)
        k4 = conv_operands.stacked_kmajor(k4, x.dtype, plan.bk)
        kshape = (4, co, 4 * conv_operands.stacked_depth(ci, plan.bk))
    else:
        xk, plan = x, conv_operands.NO_PLAN
        k4 = k4.to(x.dtype).contiguous()
        kshape = (4, 4 * ci, co)
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    cuda_lib.require(xk, "x", x.device, x.dtype, (n, h, w, xk.shape[-1]))
    cuda_lib.require(k4, "kernel", x.device, x.dtype, kshape)
    cuda_lib.require(scale, "scale", x.device, torch.float32, (co,))
    cuda_lib.require(shift, "shift", x.device, torch.float32, (co,))
    out = torch.empty((n, 2 * h, 2 * w, co), dtype=x.dtype, device=x.device)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_upsample_v2(
            code, xk.data_ptr(), k4.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), n, h, w, xk.shape[-1], co,
            *plan, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "upsample_v2")
    upsample_v2.launches += 1
    return out


cuda_lib.counted(upsample_v2)
