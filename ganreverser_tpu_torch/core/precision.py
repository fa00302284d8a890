"""The precision of the port's plain f32 operations, pinned per call.

A float32 ``F.conv2d`` on the card runs in TF32 when
``torch.backends.cudnn.allow_tf32`` is set (PyTorch's default), and a
float32 ``torch.matmul`` when ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision`` allow it. Those flags are
process-wide, so without a pin one call gives TF32 results in one process
and IEEE f32 in another. :func:`pinned_precision` sets them for the
duration of a call from the compute dtype alone and restores the caller's
values afterwards:

* ``float32``: IEEE f32 convolutions and matrix products, what the JAX
  reference computes on the CPU;
* ``bfloat16``: the operands are already rounded to bf16, which TF32 holds
  exactly (7 against 10 mantissa bits), so the products are exact and the
  sums stay f32 whatever the flags say; cuDNN may use TF32 (the faster
  path) and the matmul flag is left as the caller set it.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def pinned_precision(dtype: torch.dtype):
    """Run the block with f32 convolution and matmul precision fixed by
    ``dtype`` (see the module docstring); the caller's flags come back on
    exit, also when the block raises.

    It reads and writes the per-backend flags ``torch.backends.cudnn.
    allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32`` only:
    ``torch.get_float32_matmul_precision`` raises on some PyTorch versions
    once the per-backend flags have been set. A caller's ``"medium"``
    matmul precision comes back as ``"high"`` after an f32 call (on the
    card both mean TF32 for cuBLAS)."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    f32 = dtype == torch.float32
    try:
        torch.backends.cudnn.allow_tf32 = not f32
        if f32:
            torch.backends.cuda.matmul.allow_tf32 = False
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        if f32:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
