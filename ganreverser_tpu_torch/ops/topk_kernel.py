"""Kernel C: fused row-normalisation + cosine-score product.

The counterpart of ganreverser_tpu/ops/topk_kernel.py: scores[q, n] =
<e[needle_q], e[n]> / (|e[needle_q]| |e[n]|), with both norms computed in
the same pass over D as the dot products (``csrc/cosine_scores.cu``). The
squared norms are clamped at 1e-16, the TPU kernel's clamp, which differs
from analysis/similarity.py's clamp of the norm at 1e-8 only on degenerate
rows. Any D and any N are taken: the kernel loops over D and masks the
ragged end of N, so nothing is padded. Top-k is ``torch.topk`` outside
(analysis/similarity.py).

``cosine_scores`` launches the kernel on CUDA tensors and takes the plain
version ``cosine_scores_plain`` on CPU tensors; no other device is accepted.
``cosine_scores.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import cuda_lib

_EPS = 1e-8


def cosine_scores_plain(embeddings: torch.Tensor,
                        needle_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: (Q, N) f32."""
    e = embeddings.float()
    q = e.index_select(0, needle_idx)
    qn = q * torch.rsqrt(torch.clamp_min((q * q).sum(1, keepdim=True),
                                         _EPS * _EPS))
    en = e * torch.rsqrt(torch.clamp_min((e * e).sum(1, keepdim=True),
                                         _EPS * _EPS))
    return qn @ en.T


def cosine_scores(embeddings: torch.Tensor,
                  needle_idx: torch.Tensor) -> torch.Tensor:
    """embeddings: (N, D) f32 or bf16; needle_idx: (Q,) int64 row indices.
    Returns (Q, N) f32 cosine scores."""
    needle_idx = needle_idx.to(device=embeddings.device, dtype=torch.int64)
    if cuda_lib.dispatch_device(embeddings) == "cpu":
        return cosine_scores_plain(embeddings, needle_idx)
    n, d = embeddings.shape
    needles = embeddings.index_select(0, needle_idx).contiguous()
    q = needles.shape[0]
    cuda_lib.require(embeddings, "embeddings", embeddings.device,
                     embeddings.dtype, (n, d))
    cuda_lib.require(needles, "needles", embeddings.device, embeddings.dtype,
                     (q, d))
    out = torch.empty((q, n), dtype=torch.float32, device=embeddings.device)
    with torch.cuda.device(embeddings.device):
        rc = cuda_lib.library().gr_cosine_scores(
            cuda_lib.dtype_code(embeddings), needles.data_ptr(),
            embeddings.data_ptr(), out.data_ptr(), q, n, d,
            cuda_lib.stream_of(embeddings))
    cuda_lib.check(rc, "cosine_scores")
    cosine_scores.launches += 1
    return out


cosine_scores.launches = 0

