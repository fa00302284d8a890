"""Timing helpers — the counterparts of ganreverser_tpu/utils/timing.py.

The card runs asynchronously to the host: a host clock around a call
measures its enqueue unless the work is waited for. On a CUDA result these
helpers time with CUDA events recorded around the calls; on the CPU, where
torch's operations return finished, with ``time.perf_counter``. Each times
a warm call: the first call (kernel builds, caches) is run and waited for
before the clock starts. Times are in seconds.
"""
from __future__ import annotations

import time

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def force(x):
    """Wait for the device of the first tensor leaf of ``x`` (a tensor or
    a dict/list/tuple of them) to finish its queued work."""
    leaf = _first_tensor(x)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def time_best(fn, *args, repeats: int = 5) -> float:
    """Best-of-``repeats`` time of one warm ``fn(*args)``."""
    out = fn(*args)
    force(out)
    leaf = _first_tensor(out)
    on_card = leaf is not None and leaf.is_cuda
    best = float("inf")
    for _ in range(repeats):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
    return best


def time_amortized(fn, *args, iters: int = 20, repeats: int = 3) -> float:
    """Per-call time of ``fn(*args)`` over ``iters`` back-to-back calls
    (the best of ``repeats`` such runs): one call's launch and host costs
    overlap the previous call's device work, as in a loop of real calls."""
    def loop(*a):
        for _ in range(iters):
            out = fn(*a)
        return out

    return time_best(loop, *args, repeats=repeats) / iters
