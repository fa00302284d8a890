"""Metrics of one process — ganreverser_tpu/io/metrics.py's
``MetricsWriter``, ``StepTimer`` and ``profiler_trace``:

* scalars -> a JSONL event file, one record per line,
  ``{"tag", "value", "wall"[, "step"]}``, ``wall`` in seconds since the
  writer opened;
* image grids and loss charts -> PNG files under ``<save>/<subdir>``;
* a profiler trace of a region -> a Chrome trace JSON under a directory
  (JAX writes a TensorBoard profile plugin directory instead);
* spans: named ranges at the program's layer boundaries (``gr.*``), a flag
  check each unless a ``torch.profiler`` records; then they lie in its
  trace on the clock of every kernel, with their device time between two
  CUDA events (:func:`span`, :func:`spans`).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

_profiling = torch._C._autograd._profiler_enabled


class MetricsWriter:
    """Appends scalars to ``<save_dir>/<name>.jsonl``; close it, or use it
    as a context manager."""

    def __init__(self, save_dir: str, name: str = "events"):
        os.makedirs(save_dir, exist_ok=True)
        self.save_dir = save_dir
        self.path = os.path.join(save_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def scalar(self, tag: str, value, step: Optional[int] = None, **extra):
        rec = {"tag": tag, "value": float(value),
               "wall": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        rec.update(extra)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def image_grid(self, tag: str, images, grid_h: int, grid_w: int,
                   epoch: Optional[int] = None,
                   subdir: str = "images") -> str:
        """Save NHWC ``images`` as a (grid_h x grid_w) grid to
        ``<save>/<subdir>/<tag>[_<epoch:06d>].png``, stamped with
        ``epoch``."""
        from ..utils.grids import save_images_as_grid
        fname = f"{tag}_{epoch:06d}.png" if epoch is not None else f"{tag}.png"
        path = os.path.join(self.save_dir, subdir, fname)
        save_images_as_grid(path, np.asarray(images), grid_h, grid_w, epoch)
        return path

    def chart(self, tag: str, rows, labels, *, title: str = "",
              subdir: str = "images") -> str:
        """Render a loss chart (io/plots.py) to ``<save>/<subdir>/<tag>.png``,
        overwritten on each call, like the reference's live display
        window."""
        from .plots import save_chart
        path = os.path.join(self.save_dir, subdir, f"{tag}.png")
        return save_chart(path, rows, labels, title=title)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StepTimer:
    """Mean seconds per step, written as one scalar every ``log_every``
    ticks (replaces xlua.progress, adversarial.lua:194)."""

    def __init__(self, writer: Optional[MetricsWriter] = None,
                 log_every: int = 100, tag: str = "step_time"):
        self.writer = writer
        self.log_every = log_every
        self.tag = tag
        self._last = time.perf_counter()
        self._count = 0
        self._acc = 0.0

    def tick(self, step: Optional[int] = None) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._count += 1
        self._acc += dt
        if self.writer and self._count % self.log_every == 0:
            self.writer.scalar(self.tag, self._acc / self.log_every,
                               step=step)
            self._acc = 0.0
        return dt


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str],
                   device: torch.device | str = "cpu"):
    """A ``torch.profiler`` trace of the region, written as
    ``<log_dir>/trace_<pid>_<time>.json`` (Chrome trace format) when it
    ends; on a CUDA ``device`` the card's activity is recorded too, the
    region ending in a synchronisation. Does nothing when ``log_dir`` is
    empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Span(NamedTuple):
    """One span that ran while a profiler recorded."""
    name: str
    parent: Optional[str]      # the enclosing span's name; None at a root
    root: int                  # the id of its root span, shared by the
                               # spans of one call, chunk or epoch
    device_ms: Optional[float]  # between its entry and exit on the CUDA
                                # stream; None off the card, in a graph
                                # capture, or while it is open


_SPANS: list = []   # the spans entered while a profiler recorded, in entry
                    # order (the profiler holds every kernel's record
                    # meanwhile, so this needs no cap)
_OPEN: list = []    # the spans entered and not yet left, innermost last
_ROOT_IDS = itertools.count()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "parent", "root", "start", "end", "_range")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = None

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        outer = _OPEN[-1] if _OPEN else None
        self.parent = outer.name if outer else None
        self.root = outer.root if outer else next(_ROOT_IDS)
        if (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        _SPANS.append(self)
        _OPEN.append(self)

    def __exit__(self, *exc):
        _OPEN.pop()
        if self.start is not None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()
        return self._range.__exit__(*exc)


def span(name: str):
    """A context manager around one layer's work, named ``name``
    (``gr.<layer>.<part>``). Unless a ``torch.profiler`` records, it does
    nothing but that check. While one records, the range is a
    ``record_function`` in the trace (an idle gap of the device whose host
    is in no torch operation is then named by the innermost span), its
    device interval is taken between two timing events on the current CUDA
    stream (none while the stream captures a graph), and it is kept for
    :func:`spans`. Spans nest on one thread."""
    if not _profiling():
        return _OFF
    return _Span(name)


def spans() -> list:
    """The :class:`Span` of every span entered while a profiler recorded,
    since :func:`clear_spans`, in entry order (a root before what it
    holds); each device interval is read here, waiting for its end event."""
    out = []
    for s in _SPANS:
        ms = None
        if s.end is not None:
            s.end.synchronize()
            ms = s.start.elapsed_time(s.end)
        out.append(Span(s.name, s.parent, s.root, ms))
    return out


def clear_spans():
    """Forget the spans kept so far (:func:`profiler_trace` does so when it
    starts)."""
    _SPANS.clear()
