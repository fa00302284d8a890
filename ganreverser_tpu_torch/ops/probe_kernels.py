"""Kernel B9: the three backend probes of benchmarks/tpu_pallas_probe.py
(``trivial``, ``gridded``, ``with_dot``) as tiny CUDA kernels
(``csrc/probes.cu``), each with its plain version:

* :func:`add_one` — x + 1 over an f32 array in one block;
* :func:`times_two` — 2 x over a (G, ...) f32 array, a grid over (slice,
  leading index) with 16-byte accesses, each block within one leading
  index;
* :func:`dot_bf16` — (M,K) x (K,N) bf16 -> f32 on the tensor cores
  (wmma), M, N, K multiples of 16.

On CUDA tensors each launches its kernel (and counts it on its
``launches``); on CPU tensors each takes its plain version.
"""
from __future__ import annotations

import torch

from . import cuda_lib


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def times_two_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def dot_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of the bf16 operands."""
    return a.float() @ b.float()


def add_one(x: torch.Tensor) -> torch.Tensor:
    if cuda_lib.dispatch_device(x) == "cpu":
        return add_one_plain(x)
    cuda_lib.require(x, "x", x.device, torch.float32, tuple(x.shape))
    y = torch.empty_like(x)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_probe_add_one(
            x.data_ptr(), y.data_ptr(), x.numel(), cuda_lib.stream_of(x))
    cuda_lib.check(rc, "add_one")
    add_one.launches += 1
    return y


def times_two(x: torch.Tensor) -> torch.Tensor:
    if cuda_lib.dispatch_device(x) == "cpu":
        return times_two_plain(x)
    cuda_lib.require(x, "x", x.device, torch.float32, tuple(x.shape))
    y = torch.empty_like(x)
    with cuda_lib.on_device(x):
        rc = cuda_lib.library().gr_probe_times_two(
            x.data_ptr(), y.data_ptr(), x.shape[0], x[0].numel(),
            cuda_lib.stream_of(x))
    cuda_lib.check(rc, "times_two")
    times_two.launches += 1
    return y


def dot_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if cuda_lib.dispatch_device(a, b) == "cpu":
        return dot_bf16_plain(a, b)
    (m, k), n = a.shape, b.shape[1]
    if m % 16 or n % 16 or k % 16:
        raise ValueError(f"dot_bf16 takes multiples of 16, got ({m},{k}) x "
                         f"({k},{n})")
    cuda_lib.require(a, "a", a.device, torch.bfloat16, (m, k))
    cuda_lib.require(b, "b", a.device, torch.bfloat16, (k, n))
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with cuda_lib.on_device(a):
        rc = cuda_lib.library().gr_probe_dot_bf16(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
            cuda_lib.stream_of(a))
    cuda_lib.check(rc, "dot_bf16")
    dot_bf16.launches += 1
    return c


cuda_lib.counted(add_one)
cuda_lib.counted(times_two)
cuda_lib.counted(dot_bf16)
