"""Kernel U: fused nearest-upsample(2x) + 3x3 conv + BN(eval) + activation.

The counterpart of ganreverser_tpu/ops/upsample_conv_kernel.py: G's two
upsample blocks as one kernel that reads the low-resolution input once and
writes the upsampled output once. The weights are aggregated on the host
into four 2x2 phase kernels (``phase_kernels``, the same aggregation); the
CUDA kernel (``csrc/upsample_conv.cu``) runs the phases as blocks of an
implicit GEMM with the scale/shift and activation in the epilogue: bf16 on
the tensor cores (``csrc/conv_wgmma.cuh``, operands laid out by
``conv_operands``), f32 on the CUDA cores.

``upsample2_conv3x3_bn_act`` (a custom operator of ops/library.py)
launches the kernel on CUDA tensors and takes the plain version
``upsample2_conv3x3_bn_act_plain`` on CPU tensors; no other device is
accepted. ``upsample2_conv3x3_bn_act.launches`` counts the
kernel launches.

With ``final_kernel``/``final_bias`` the call is the TPU kernel's fused
final head (G's 128 -> C output conv): U's output is rounded once to the
storage type and, zero-padded, goes through a 3x3 conv to Cf channels +
bias + ``final_act`` (``csrc/upsample_conv.cu``'s
``gr_upsample2_conv3x3_head``), and the (N,2H,2W,Co) intermediate never
reaches device memory. In f32 that is one CUDA-core launch. In bf16 it is
two: U's tensor-core tile whose epilogue writes each U pixel's nine tap
partials of the head (a second tensor-core product, f32, 9 * Cf a pixel
per channel block: :func:`head_tap_partials_plain`), then a launch that
adds each output pixel's in-image neighbours, the bias and the act
(:func:`head_finish_plain`). The variant counts its calls on
``upsample2_conv3x3_head.launches``, one per call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import conv_operands, cuda_lib
from .upsample_conv import conv_nhwc

_ACTS = ("relu", "none", "sigmoid")


def _aggregate(k: torch.Tensor, axis: int) -> torch.Tensor:
    """Sums of the three taps of ``axis`` into four slots, index a * 2 + t:
    phase a = 0 takes taps {0} and {1, 2}, phase a = 1 taps {0, 1} and
    {2}."""
    t0, t1, t2 = k.unbind(axis)
    return torch.stack([t0, t1 + t2, t0 + t1, t2], axis)


def phase_kernels(kernel: torch.Tensor) -> torch.Tensor:
    """(3,3,Ci,Co) -> (2,2,2,2,Ci,Co) phase-aggregated 2x2 kernels indexed
    [a, ta, b, tb], summed in f32 and rounded once to ``kernel.dtype`` (so a
    bf16 kernel gives bf16 sums of its bf16 taps). The JAX package's einsum
    with its 0/1 map, done as slice sums: an einsum over the whole kernel
    cost as much device time as kernel U itself."""
    agg = _aggregate(_aggregate(kernel.float(), 0), 1)
    return agg.reshape(2, 2, 2, 2, *kernel.shape[2:]).to(kernel.dtype)


def phase_operand(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A (3,3,Ci,Co) HWIO kernel as the kernel reads it in ``dtype``: the
    16 phase taps of :func:`phase_kernels`, bf16 K-major and padded as
    (16, Co, Ci') (``conv_operands.kmajor``), f32 as (16, Ci, Co). A caller
    that runs the same weights many times lays them out once."""
    ci, co = kernel.shape[2:]
    k16 = phase_kernels(kernel.to(dtype)).reshape(16, ci, co)
    if dtype == torch.bfloat16:
        return conv_operands.kmajor(k16, dtype)
    return k16.contiguous()


def head_operand(final_kernel: torch.Tensor, dtype: torch.dtype,
                 h: int, w: int, ci: int) -> torch.Tensor:
    """The fused head's (3,3,Co,Cf) weights as the kernel reads them in
    ``dtype`` at U's input (H, W, Ci): bf16 the second product's K-major
    tile (``conv_operands.head_weights`` for ``head_plan``'s BN), f32 the
    kernel itself, contiguous."""
    if dtype == torch.bfloat16:
        co, cf = final_kernel.shape[2:]
        bn = conv_operands.head_plan(h, w, ci, co, cf).bn
        return conv_operands.head_weights(final_kernel, dtype, bn)
    return final_kernel.to(dtype).contiguous()


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


def head_tap_partials_plain(x, kernel, scale, shift, final_kernel, *,
                            act: str = "relu") -> torch.Tensor:
    """The bf16 head's first launch in plain PyTorch on any device: U's
    output rounded to ``x.dtype`` (:func:`upsample2_conv3x3_bn_act_plain`),
    and per channel block of ``conv_operands.head_plan``'s BN and output
    phase, each U pixel's contribution to the head's nine taps, operands in
    ``x.dtype``, f32 sums. Returns the workspace
    (``conv_operands.head_workspace_shape``) f32."""
    n, h, w, ci = x.shape
    co, cf = final_kernel.shape[2:]
    bn = conv_operands.head_plan(h, w, ci, co, cf).bn
    u = upsample2_conv3x3_bn_act_plain(x, kernel, scale, shift, act=act)
    fk = final_kernel.to(x.dtype).float().reshape(9, co, cf)
    out = torch.empty(conv_operands.head_workspace_shape(n, h, w, co, cf, bn),
                      dtype=torch.float32, device=x.device)
    for b in range(out.shape[0]):
        cs = slice(b * bn, (b + 1) * bn)
        for a in (0, 1):
            for c in (0, 1):
                up = u[:, a::2, c::2, cs].float()
                out[b, 2 * a + c] = torch.einsum(
                    "nhwc,tcf->nhwtf", up, fk[:, cs]).reshape(n, h, w, -1)
    return out


def head_finish_plain(taps: torch.Tensor, final_bias: torch.Tensor, *,
                      final_act: str = "sigmoid",
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The bf16 head's second launch in plain PyTorch on any device: output
    pixel p adds, for each tap t = (dy, dx) in order and each channel block
    in order, t's partial of U pixel p + (dy - 1, dx - 1) where that pixel
    is in the image, then ``final_bias`` and ``final_act``, rounded to
    ``dtype``. ``taps``: (blocks, 4, N, H, W, 9 * Cf) f32. Returns
    (N, 2H, 2W, Cf)."""
    blocks, _, n, h, w, k = taps.shape
    cf = k // 9
    v = (taps.reshape(blocks, 2, 2, n, h, w, 9, cf)
         .permute(0, 3, 4, 1, 5, 2, 6, 7).reshape(blocks, n, 2 * h, 2 * w,
                                                  9, cf))
    v = F.pad(v, (0, 0, 0, 0, 1, 1, 1, 1))  # pixels outside add nothing
    s = torch.zeros((n, 2 * h, 2 * w, cf), dtype=torch.float32,
                    device=taps.device)
    for t in range(9):
        dy, dx = divmod(t, 3)
        for b in range(blocks):
            s = s + v[b, :, dy:dy + 2 * h, dx:dx + 2 * w, t]
    return _act(s + final_bias.float(), final_act).to(dtype)


def upsample2_conv3x3_bn_act(x: torch.Tensor, kernel: torch.Tensor,
                             scale: torch.Tensor, shift: torch.Tensor, *,
                             act: str = "relu", final_kernel=None,
                             final_bias=None, final_act: str = "sigmoid",
                             operand: torch.Tensor | None = None,
                             final_operand: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """x: (N,H,W,Ci) NHWC; kernel: (3,3,Ci,Co), the unfused conv's HWIO
    weights; scale/shift: (Co,) from fold_batchnorm (scale=1, shift=bias for
    a plain conv). Returns (N,2H,2W,Co) in ``x.dtype``. Eval-mode only.
    ``operand``: ``kernel`` laid out beforehand by :func:`phase_operand`
    for ``x.dtype`` (else on every call; the plain version reads
    ``kernel``). Runs as the custom operator
    ``ganreverser::upsample2_conv3x3_bn_act`` (ops/library.py).

    With ``final_kernel`` (3,3,Co,Cf) and ``final_bias`` (Cf,), the fused
    head (:func:`upsample2_conv3x3_head`): returns (N,2H,2W,Cf)."""
    if final_kernel is not None:
        return upsample2_conv3x3_head(x, kernel, scale, shift, final_kernel,
                                      final_bias, act=act,
                                      final_act=final_act, operand=operand,
                                      final_operand=final_operand)
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    cuda_lib.dispatch_device(x, kernel, scale, shift)
    return torch.ops.ganreverser.upsample2_conv3x3_bn_act(
        x, kernel, scale, shift, act, operand)


def launch_upsample2_conv3x3_bn_act(x: torch.Tensor, kernel: torch.Tensor,
                                    scale: torch.Tensor, shift: torch.Tensor,
                                    act: str, operand: torch.Tensor | None
                                    ) -> torch.Tensor:
    """The body of ``ganreverser::upsample2_conv3x3_bn_act``: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if cuda_lib.dispatch_device(x, kernel, scale, shift) == "cpu":
        return upsample2_conv3x3_bn_act_plain(x, kernel, scale, shift,
                                              act=act)
    code = cuda_lib.dtype_code(x)
    n, h, w, ci = x.shape
    co = kernel.shape[-1]
    k16 = phase_operand(kernel, x.dtype) if operand is None else operand
    if x.dtype == torch.bfloat16:  # the tensor-core tile's operands
        xk = conv_operands.pad_channels(x)
        plan = conv_operands.tile_plan(h, w, ci, co)
        kshape = (16, co, xk.shape[-1])
    else:
        xk, plan = x, conv_operands.NO_PLAN
        kshape = (16, ci, co)
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    cuda_lib.require(xk, "x", x.device, x.dtype, (n, h, w, xk.shape[-1]))
    cuda_lib.require(k16, "kernel", x.device, x.dtype, kshape)
    cuda_lib.require(scale, "scale", x.device, torch.float32, (co,))
    cuda_lib.require(shift, "shift", x.device, torch.float32, (co,))
    out = torch.empty((n, 2 * h, 2 * w, co), dtype=x.dtype, device=x.device)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_upsample2_conv3x3_bn_act(
            code, xk.data_ptr(), k16.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), n, h, w, xk.shape[-1], co,
            cuda_lib.ACT_CODES[act], *plan, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "upsample2_conv3x3_bn_act")
    upsample2_conv3x3_bn_act.launches += 1
    return out


cuda_lib.counted(upsample2_conv3x3_bn_act)


def upsample2_conv3x3_head(x: torch.Tensor, kernel: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor,
                           final_kernel: torch.Tensor,
                           final_bias: torch.Tensor, *, act: str = "relu",
                           final_act: str = "sigmoid",
                           operand: torch.Tensor | None = None,
                           final_operand: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """U followed by the fused 3x3 head: ``final_kernel`` (3,3,Co,Cf) HWIO
    with 1 <= Cf <= 4, ``final_bias`` (Cf,). Returns (N,2H,2W,Cf) in
    ``x.dtype``; the kernel on CUDA tensors (bf16: the tap partials in a
    workspace of ``conv_operands.head_workspace_shape``, 113 MB at G3's
    stage 2 and N = 256), the plain version on CPU tensors. ``operand``
    and ``final_operand``: the weights laid out beforehand by
    :func:`phase_operand` and :func:`head_operand` (else on every call).
    Runs as the custom operator ``ganreverser::upsample2_conv3x3_head``
    (ops/library.py)."""
    for name, a in (("act", act), ("final_act", final_act)):
        if a not in _ACTS:
            raise ValueError(f"{name} must be one of {_ACTS}, got {a!r}")
    if final_bias is None:
        raise ValueError("final_kernel needs final_bias")
    cuda_lib.dispatch_device(x, kernel, scale, shift, final_kernel,
                             final_bias)
    return torch.ops.ganreverser.upsample2_conv3x3_head(
        x, kernel, scale, shift, final_kernel, final_bias, act, final_act,
        operand, final_operand)


def launch_upsample2_conv3x3_head(x: torch.Tensor, kernel: torch.Tensor,
                                  scale: torch.Tensor, shift: torch.Tensor,
                                  final_kernel: torch.Tensor,
                                  final_bias: torch.Tensor, act: str,
                                  final_act: str,
                                  operand: torch.Tensor | None,
                                  final_operand: torch.Tensor | None
                                  ) -> torch.Tensor:
    """The body of ``ganreverser::upsample2_conv3x3_head``: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
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
    if tuple(final_kernel.shape[:3]) != (3, 3, co):
        raise ValueError(f"final_kernel {tuple(final_kernel.shape)} does not "
                         f"take U's {co} channels")
    code = cuda_lib.dtype_code(x)
    k16 = phase_operand(kernel, x.dtype) if operand is None else operand
    fk = (head_operand(final_kernel, x.dtype, h, w, ci)
          if final_operand is None else final_operand)
    if x.dtype == torch.bfloat16:  # U's tensor-core tile + the tap partials
        xk = conv_operands.pad_channels(x)
        plan = conv_operands.head_plan(h, w, ci, co, cf)
        kshape = (16, co, xk.shape[-1])
        fshape = (conv_operands.head_rows(cf),
                  -(-co // plan.bn) * plan.bn)
        ws = torch.empty(conv_operands.head_workspace_shape(
            n, h, w, co, cf, plan.bn), dtype=torch.float32, device=x.device)
    else:
        xk, plan = x, conv_operands.NO_PLAN
        kshape, fshape = (16, ci, co), (3, 3, co, cf)
        ws = None
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    fb = final_bias.float().contiguous()
    cuda_lib.require(xk, "x", x.device, x.dtype, (n, h, w, xk.shape[-1]))
    cuda_lib.require(k16, "kernel", x.device, x.dtype, kshape)
    cuda_lib.require(scale, "scale", x.device, torch.float32, (co,))
    cuda_lib.require(shift, "shift", x.device, torch.float32, (co,))
    cuda_lib.require(fk, "final_kernel", x.device, x.dtype, fshape)
    cuda_lib.require(fb, "final_bias", x.device, torch.float32, (cf,))
    out = torch.empty((n, 2 * h, 2 * w, cf), dtype=x.dtype, device=x.device)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_upsample2_conv3x3_head(
            code, xk.data_ptr(), k16.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), fk.data_ptr(), fb.data_ptr(),
            None if ws is None else ws.data_ptr(), out.data_ptr(), n, h, w,
            xk.shape[-1], co, cf, cuda_lib.ACT_CODES[act],
            cuda_lib.ACT_CODES[final_act], *plan, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "upsample2_conv3x3_head")
    upsample2_conv3x3_head.launches += 1
    return out


cuda_lib.counted(upsample2_conv3x3_head)
