"""Batched model application — NN_UTILS.forwardBatched (nn_utils.lua:5-33),
the counterpart of ganreverser_tpu/analysis/batched.py."""
from __future__ import annotations

from typing import Callable

import torch


def forward_batched(apply_fn: Callable, x: torch.Tensor,
                    batch_size: int) -> torch.Tensor:
    """Apply ``apply_fn`` (batch -> batch) over ``x`` in chunks of exactly
    ``batch_size`` rows; the last chunk is padded with copies of the last row
    and the padding is cut from the result, so ``apply_fn`` sees one shape."""
    n = x.shape[0]
    if n <= batch_size:
        return apply_fn(x)
    outs = []
    for start in range(0, n, batch_size):
        chunk = x[start:start + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = torch.cat([chunk, chunk[-1:].expand(
                (pad,) + tuple(chunk.shape[1:]))])
        outs.append(apply_fn(chunk))
    return torch.cat(outs)[:n]
