"""Batched model application — NN_UTILS.forwardBatched (nn_utils.lua:5-33),
the counterpart of ganreverser_tpu/analysis/batched.py."""
from __future__ import annotations

from typing import Callable

import torch


def forward_batched(apply_fn: Callable, x: torch.Tensor, batch_size: int):
    """Apply ``apply_fn`` (batch -> batch) over ``x`` in chunks of exactly
    ``batch_size`` rows; the last chunk is padded with copies of the last row
    and the padding is cut from the result, so ``apply_fn`` sees one shape.

    ``apply_fn`` may return a tuple of tensors (the fused e2e program's
    chunks return embeddings and flat pixels): each is unchunked. The
    chunks' outputs are written into one tensor per output as they come,
    so at most one chunk's output is held beside the result."""
    n = x.shape[0]
    if n <= batch_size:
        return apply_fn(x)
    outs = None
    for start in range(0, n, batch_size):
        chunk = x[start:start + batch_size]
        rows = chunk.shape[0]
        if rows < batch_size:
            chunk = torch.cat([chunk, chunk[-1:].expand(
                (batch_size - rows,) + tuple(chunk.shape[1:]))])
        got = apply_fn(chunk)
        parts = got if isinstance(got, tuple) else (got,)
        if outs is None:
            outs = tuple(p.new_empty((n,) + tuple(p.shape[1:]))
                         for p in parts)
        for out, p in zip(outs, parts):
            out[start:start + rows] = p[:rows]
    return outs if isinstance(got, tuple) else outs[0]
