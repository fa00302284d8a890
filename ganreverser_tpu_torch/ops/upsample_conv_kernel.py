"""Kernel U: fused nearest-upsample(2x) + 3x3 conv + BN(eval) + activation.

The counterpart of ganreverser_tpu/ops/upsample_conv_kernel.py: G's two
upsample blocks as one kernel that reads the low-resolution input once and
writes the upsampled output once. The weights are aggregated on the host
into four 2x2 phase kernels (``phase_kernels``, the same ``_AGG`` map); the
CUDA kernel (``csrc/upsample_conv.cu``) runs the phases as blocks of an
implicit GEMM with the scale/shift and activation in the epilogue.

``upsample2_conv3x3_bn_act`` launches the kernel on CUDA tensors and takes
the plain version ``upsample2_conv3x3_bn_act_plain`` on CPU tensors; no
other device is accepted. ``upsample2_conv3x3_bn_act.launches`` counts the
kernel launches.

With ``final_kernel``/``final_bias`` the call is the TPU kernel's fused
final head (G's 128 -> C output conv): U's output is rounded once to the
storage type and, zero-padded, goes through a 3x3 conv to Cf channels +
bias + ``final_act`` in the same launch (``csrc/upsample_conv.cu``'s
``gr_upsample2_conv3x3_head``), so the (N,2H,2W,Co) intermediate never
reaches device memory. That variant counts its launches on
``upsample2_conv3x3_head.launches``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .upsample_conv import conv_nhwc

# per-axis aggregation: _AGG[a, t, u] = 1 iff input tap u feeds phase a slot t
_AGG = ((( 1.0, 0.0, 0.0), (0.0, 1.0, 1.0)),   # a=0: U(0,0)={0}, U(0,1)={1,2}
        (( 1.0, 1.0, 0.0), (0.0, 0.0, 1.0)))   # a=1: U(1,0)={0,1}, U(1,1)={2}

_ACTS = ("relu", "none", "sigmoid")


def phase_kernels(kernel: torch.Tensor) -> torch.Tensor:
    """(3,3,Ci,Co) -> (2,2,2,2,Ci,Co) phase-aggregated 2x2 kernels indexed
    [a, ta, b, tb], summed in f32 and rounded once to ``kernel.dtype`` (so a
    bf16 kernel gives bf16 sums of its bf16 taps)."""
    m = torch.tensor(_AGG, dtype=torch.float32, device=kernel.device)
    agg = torch.einsum("atu,bsv,uvio->atbsio", m, m, kernel.float())
    return agg.to(kernel.dtype)


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "none":
        return y
    raise ValueError(act)


def upsample2_conv3x3_bn_act_plain(x, kernel, scale, shift, *,
                                   act: str = "relu", final_kernel=None,
                                   final_bias=None,
                                   final_act: str = "sigmoid") -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: the four phase
    convs with the same aggregated weights, f32 accumulation and epilogue,
    output rounded to ``x.dtype``. With ``final_kernel`` (3,3,Co,Cf) that
    output, zero-padded, goes through the 3x3 head (operands in
    ``x.dtype``, f32 sums) + ``final_bias`` + ``final_act``, rounded to
    ``x.dtype``: the rounding points of the TPU kernel's head."""
    if final_kernel is not None:
        u = upsample2_conv3x3_bn_act_plain(x, kernel, scale, shift, act=act)
        y = conv_nhwc(u, final_kernel, 1, x.dtype) + final_bias.float()
        return _act(y, final_act).to(x.dtype)
    n, h, w, _ = x.shape
    co = kernel.shape[-1]
    k = phase_kernels(kernel.to(x.dtype)).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = torch.empty((n, h, 2, w, 2, co), dtype=torch.float32,
                      device=x.device)
    for a in (0, 1):
        for b in (0, 1):
            wt = k[a, :, b].permute(3, 2, 0, 1)  # (ta,tb,Ci,Co) -> OIHW
            y = F.conv2d(xp[:, a:a + h + 1, b:b + w + 1].permute(0, 3, 1, 2),
                         wt)
            out[:, :, a, :, b] = y.permute(0, 2, 3, 1)
    y = out.reshape(n, 2 * h, 2 * w, co) * scale.float() + shift.float()
    return _act(y, act).to(x.dtype)


def upsample2_conv3x3_bn_act(x: torch.Tensor, kernel: torch.Tensor,
                             scale: torch.Tensor, shift: torch.Tensor, *,
                             act: str = "relu", final_kernel=None,
                             final_bias=None,
                             final_act: str = "sigmoid") -> torch.Tensor:
    """x: (N,H,W,Ci) NHWC; kernel: (3,3,Ci,Co), the unfused conv's HWIO
    weights; scale/shift: (Co,) from fold_batchnorm (scale=1, shift=bias for
    a plain conv). Returns (N,2H,2W,Co) in ``x.dtype``. Eval-mode only.

    With ``final_kernel`` (3,3,Co,Cf) and ``final_bias`` (Cf,), the fused
    head (:func:`upsample2_conv3x3_head`): returns (N,2H,2W,Cf)."""
    if final_kernel is not None:
        return upsample2_conv3x3_head(x, kernel, scale, shift, final_kernel,
                                      final_bias, act=act,
                                      final_act=final_act)
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    if cuda_lib.dispatch_device(x, kernel, scale, shift) == "cpu":
        return upsample2_conv3x3_bn_act_plain(x, kernel, scale, shift,
                                              act=act)
    n, h, w, ci = x.shape
    co = kernel.shape[-1]
    k16 = phase_kernels(kernel.to(x.dtype)).reshape(16, ci, co).contiguous()
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    cuda_lib.require(x, "x", x.device, x.dtype, (n, h, w, ci))
    cuda_lib.require(k16, "kernel", x.device, x.dtype, (16, ci, co))
    cuda_lib.require(scale, "scale", x.device, torch.float32, (co,))
    cuda_lib.require(shift, "shift", x.device, torch.float32, (co,))
    out = torch.empty((n, 2 * h, 2 * w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = cuda_lib.library().gr_upsample2_conv3x3_bn_act(
            cuda_lib.dtype_code(x), x.data_ptr(), k16.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n, h, w, ci,
            co, cuda_lib.ACT_CODES[act], cuda_lib.stream_of(x))
    cuda_lib.check(rc, "upsample2_conv3x3_bn_act")
    upsample2_conv3x3_bn_act.launches += 1
    return out


upsample2_conv3x3_bn_act.launches = 0


def upsample2_conv3x3_head(x: torch.Tensor, kernel: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor,
                           final_kernel: torch.Tensor,
                           final_bias: torch.Tensor, *, act: str = "relu",
                           final_act: str = "sigmoid") -> torch.Tensor:
    """U followed by the fused 3x3 head: ``final_kernel`` (3,3,Co,Cf) HWIO
    with 1 <= Cf <= 4, ``final_bias`` (Cf,). Returns (N,2H,2W,Cf) in
    ``x.dtype``; one launch on CUDA tensors, the plain version on CPU
    tensors."""
    for name, a in (("act", act), ("final_act", final_act)):
        if a not in _ACTS:
            raise ValueError(f"{name} must be one of {_ACTS}, got {a!r}")
    if final_bias is None:
        raise ValueError("final_kernel needs final_bias")
    if cuda_lib.dispatch_device(x, kernel, scale, shift, final_kernel,
                                final_bias) == "cpu":
        return upsample2_conv3x3_bn_act_plain(
            x, kernel, scale, shift, act=act, final_kernel=final_kernel,
            final_bias=final_bias, final_act=final_act)
    n, h, w, ci = x.shape
    co = kernel.shape[-1]
    cf = final_kernel.shape[-1]
    if not 1 <= cf <= 4:
        raise ValueError(f"the fused head takes 1 to 4 output channels, got "
                         f"{cf}")
    k16 = phase_kernels(kernel.to(x.dtype)).reshape(16, ci, co).contiguous()
    fk = final_kernel.to(x.dtype).contiguous()
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    fb = final_bias.float().contiguous()
    cuda_lib.require(x, "x", x.device, x.dtype, (n, h, w, ci))
    cuda_lib.require(k16, "kernel", x.device, x.dtype, (16, ci, co))
    cuda_lib.require(scale, "scale", x.device, torch.float32, (co,))
    cuda_lib.require(shift, "shift", x.device, torch.float32, (co,))
    cuda_lib.require(fk, "final_kernel", x.device, x.dtype, (3, 3, co, cf))
    cuda_lib.require(fb, "final_bias", x.device, torch.float32, (cf,))
    out = torch.empty((n, 2 * h, 2 * w, cf), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = cuda_lib.library().gr_upsample2_conv3x3_head(
            cuda_lib.dtype_code(x), x.data_ptr(), k16.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), fk.data_ptr(), fb.data_ptr(),
            out.data_ptr(), n, h, w, ci, co, cf, cuda_lib.ACT_CODES[act],
            cuda_lib.ACT_CODES[final_act], cuda_lib.stream_of(x))
    cuda_lib.check(rc, "upsample2_conv3x3_head")
    upsample2_conv3x3_head.launches += 1
    return out


upsample2_conv3x3_head.launches = 0
