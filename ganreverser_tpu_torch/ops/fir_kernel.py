"""StyleGAN2's FIR filter on a hand-written kernel, forward and backward.

The filter is upfirdn_2d's with the separable taps f (x) f, f = [1, 3, 3,
1] / 4 on each axis (normalised to sum 1, the 2-D filter scaled by 4, the
gain of a 2x up-sampling), of each channel of an NHWC tensor. A form
``(up, down, pad0, pad1)`` puts ``up - 1`` zeros after each pixel, pads
``pad0`` rows and columns before and ``pad1`` after, filters, and keeps
every ``down``-th output. :class:`~..models.modules.FIRFilter` takes two
of them, and their adjoints give the gradients (:data:`FORMS`):

* ``up=1``, the blur after an up-sampling modulated convolution: pad (1,
  1), 2r + 1 rows in, 2r out; its gradient: pad (2, 2), 2r in, 2r + 1 out;
* ``up=2``, the skip's up-sampling of the image: pad (2, 1), r in, 2r out;
  its gradient: pad (1, 1) and down 2, 2r in, r out.

:func:`fir_filter` launches the CUDA kernel (``csrc/fir.cu``) on CUDA
tensors, forward and backward (``fir_filter.launches`` counts both;
``fir_filter.copies`` counts the non-contiguous inputs or gradients it had
to copy first), and the plain version :func:`upfirdn2d_plain` on CPU
tensors; no other device is accepted. The numbers are those of the module
path's convolutions: each input element rounded to the compute dtype, f32
taps, products and sums, an f32 result; the gradient's f32 sums rounded to
the compute dtype and returned in the input's dtype. The backward saves no
activation, only the input's dtype. Only first-order gradients: the
backward is ``once_differentiable``, so a double backward through the
filter (a gradient penalty through G, say) raises; nothing in the port
takes one.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..core.precision import pinned_precision
from . import cuda_lib

_TAPS = (0.25, 0.75, 0.75, 0.25)   # f on each axis: [1, 3, 3, 1] / 4
FIR_THREADS = 128                  # a block: csrc/fir.cu's kFirThreads
BLOCKS_PER_SM = 4                  # rows 8 where its grid has this many
# (forward form, gradient form) by ``up``, each (up, down, pad0, pad1)
FORMS = {1: ((1, 1, 1, 1), (1, 1, 2, 2)),
         2: ((2, 1, 2, 1), (1, 2, 1, 1))}
_FORWARD_FORMS = {fwd for fwd, _ in FORMS.values()}   # write f32
_GRAD_FORMS = {grad for _, grad in FORMS.values()}     # read f32
_KERNEL_FORMS = _FORWARD_FORMS | _GRAD_FORMS
_ROUNDS = (torch.float32, torch.bfloat16)


def out_size(size: int, form) -> int:
    """Rows (or columns) out of ``size`` in under ``form``."""
    up, down, pad0, pad1 = form
    return (size * up + pad0 + pad1 - len(_TAPS)) // down + 1


def fir_taps(channels: int, device) -> torch.Tensor:
    """f (x) f for each channel, (channels, 1, 4, 4) f32, as F.conv2d's
    depthwise weight; the filter is symmetric, so upfirdn_2d's flip leaves
    it as it is."""
    f = torch.tensor(_TAPS, dtype=torch.float32, device=device)
    return torch.outer(f, f).expand(channels, 1, 4, 4)


def upfirdn2d_plain(x: torch.Tensor, form, op_dtype=torch.float32,
                    sum_dtype=torch.float32,
                    out_dtype=torch.float32) -> torch.Tensor:
    """One launch as plain PyTorch on any device: NHWC ``x``'s elements
    rounded to ``op_dtype``, the zeros inserted and the padding made, the
    filter as a depthwise f32 convolution (IEEE f32 on the card) with
    stride ``down``, the sums rounded to ``sum_dtype``, held in
    ``out_dtype``."""
    up, down, pad0, pad1 = form
    n, h, w, c = x.shape
    xt = x.to(op_dtype).float().permute(0, 3, 1, 2)
    if up > 1:
        z = xt.new_zeros(n, c, h * up, w * up)
        z[:, :, ::up, ::up] = xt
        xt = z
    xt = F.pad(xt, (pad0, pad1, pad0, pad1))
    with pinned_precision(torch.float32):
        y = F.conv2d(xt, fir_taps(c, x.device), stride=down, groups=c)
    return y.to(sum_dtype).to(out_dtype).permute(0, 2, 3, 1)


class FirPlan(NamedTuple):
    vec: int    # channels a thread: 16 bytes of the input's dtype, or 1
    rows: int   # output rows a thread: 8, or 2 on a small grid


def fir_plan(n: int, ho: int, wo: int, c: int, elem_bytes: int,
             aligned: bool, sms: int) -> FirPlan:
    """16-byte loads where C holds whole packs and the tensors are
    aligned (one element a thread otherwise: the 3-channel skip); 8 rows a
    thread where that grid gives every one of ``sms`` SMs
    :data:`BLOCKS_PER_SM` blocks, else 2."""
    per = 16 // elem_bytes
    vec = per if aligned and c % per == 0 else 1
    blocks = -(-(wo * c // vec) // FIR_THREADS) * n
    rows = 8 if blocks * -(-ho // 8) >= BLOCKS_PER_SM * sms else 2
    return FirPlan(vec, rows)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x: torch.Tensor, form, op_dtype, sum_dtype,
            out_dtype) -> torch.Tensor:
    if form not in _KERNEL_FORMS:
        raise ValueError(f"FIR form (up, down, pad0, pad1) {form}: the "
                         f"kernel takes {sorted(_KERNEL_FORMS)}")
    if (out_dtype if form in _FORWARD_FORMS else x.dtype) != torch.float32:
        raise TypeError(f"FIR form {form}: the kernel's forward forms write "
                        "float32 and its gradient forms read float32")
    n, h, w, c = x.shape
    ho, wo = out_size(h, form), out_size(w, form)
    if ho < 1 or wo < 1:
        raise ValueError(f"FIR form {form} of a {h} x {w} input is empty")
    if not x.is_contiguous():
        x = x.contiguous()
        fir_filter.copies += 1
    y = torch.empty((n, ho, wo, c), dtype=out_dtype, device=x.device)
    aligned = (x.data_ptr() | y.data_ptr()) % 16 == 0
    plan = fir_plan(n, ho, wo, c, x.element_size(), aligned,
                    _sm_count(x.device.index))
    up, down, pad0, _ = form
    args = (cuda_lib.dtype_code(x), cuda_lib.DTYPE_CODES[out_dtype],
            x.data_ptr(), y.data_ptr(), n, h, w, ho, wo, c, up, down, pad0,
            int(op_dtype == torch.bfloat16), int(sum_dtype == torch.bfloat16),
            plan.vec, plan.rows, cuda_lib.stream_of(x))
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_fir_filter(*args)
    cuda_lib.check(rc, "fir_filter")
    fir_filter.launches += 1
    return y


def upfirdn2d(x: torch.Tensor, form, op_dtype=torch.float32,
              sum_dtype=torch.float32,
              out_dtype=torch.float32) -> torch.Tensor:
    """One pass of the filter in ``form`` over NHWC ``x`` (f32 or bf16),
    with the roundings of :func:`upfirdn2d_plain`: the kernel on a CUDA
    tensor (a forward form writes f32, a gradient form reads f32, as
    :class:`_FIRFilter` calls them), the plain version on a CPU one. Not
    differentiable."""
    for name, dt in (("op", op_dtype), ("sum", sum_dtype),
                     ("out", out_dtype)):
        if dt not in _ROUNDS:
            raise TypeError(f"FIR {name} dtype {dt}: float32 or bfloat16")
    if x.dim() != 4:
        raise ValueError(f"FIR input must be NHWC, got {tuple(x.shape)}")
    if cuda_lib.dispatch_device(x) == "cpu":
        return upfirdn2d_plain(x, form, op_dtype, sum_dtype, out_dtype)
    return _launch(x, form, op_dtype, sum_dtype, out_dtype)


class _FIRFilter(torch.autograd.Function):
    """The forward form; the backward is the gradient form over the
    incoming gradient, its sums rounded to the compute dtype and held in
    the input's dtype (what autograd returns through ``x.to(dtype)
    .float()``)."""

    @staticmethod
    def forward(ctx, x, up, dtype):
        ctx.up, ctx.dtype, ctx.x_dtype = up, dtype, x.dtype
        return upfirdn2d(x, FORMS[up][0], dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return upfirdn2d(grad, FORMS[ctx.up][1], torch.float32, ctx.dtype,
                         ctx.x_dtype), None, None


def fir_filter(x: torch.Tensor, up: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``FIRFilter``'s filter of NHWC ``x``: ``up=1`` the blur (2r + 1 ->
    2r), ``up=2`` the up-sampling (r -> 2r); ``x`` rounded to ``dtype``,
    f32 result, differentiable in ``x``."""
    if up not in FORMS:
        raise ValueError(f"FIR up {up}: expected 1 or 2")
    if not (x.requires_grad and torch.is_grad_enabled()):
        return upfirdn2d(x, FORMS[up][0], dtype)  # no graph to record
    return _FIRFilter.apply(x, up, dtype)


cuda_lib.counted(fir_filter)
fir_filter.copies = 0   # non-contiguous inputs copied before a launch
