"""The traced window and what is read from its device trace.

The arithmetic is ``tools/profile_port.py``'s: device busy time is the
union of the intervals of every kernel, memcpy and memset in the Chrome
trace that ``torch.profiler`` exports, so nothing is counted twice; the idle
share is 1 - busy / window. Device operations are put into classes by
substrings of their names (``kernels.json``'s ``classes``, the first match
wins). The traced window is the span of a ``record_function`` range around
the traced steps, on the trace's own clock.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
WINDOW = "portbench.window"


class Trace(NamedTuple):
    ops: list          # (name, start_us, end_us) of each device operation
    host: list         # (name, start_us, end_us) of each host operation
    window_us: tuple   # (start_us, end_us) of the traced window
    steps: int         # steps run inside the window

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6


def read_chrome_trace(path: str, steps: int) -> Trace:
    """The device and host operations of an exported trace, and the span of
    its ``WINDOW`` range."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        iv = (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat in DEVICE_CATS:
            ops.append(iv)
        elif cat in HOST_CATS:
            if e["name"] == WINDOW and cat == "user_annotation":
                window = iv[1:]
            else:
                host.append(iv)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    return Trace(ops, host, window, steps)


def traced_window(step, steps: int, sync) -> Trace:
    """Run ``step`` ``steps`` times under ``torch.profiler`` (host and
    device activity), then ``sync``; the trace is written to a temporary
    file, read and removed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(steps):
                step()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, steps)
    finally:
        os.remove(path)


def merged(intervals) -> list:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted((s, e) for _, s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(intervals) -> float:
    """Length of the union of (name, start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def busy_s(trace: Trace) -> float:
    """Seconds in which some device operation ran, inside the window."""
    lo, hi = trace.window_us
    clipped = [(n, max(s, lo), min(e, hi)) for n, s, e in trace.ops
               if e > lo and s < hi]
    return union_us(clipped) / 1e6


def idle_share(trace: Trace) -> float:
    return 1.0 - busy_s(trace) / trace.window_s


def matches(name: str, patterns) -> bool:
    low = name.lower()
    return any(p.lower() in low for p in patterns)


def kernel_class(name: str, classes) -> str:
    """The class of a device operation: the first of ``classes`` ((class,
    substrings) pairs) whose substrings its name holds."""
    for cls, patterns in classes:
        if matches(name, patterns):
            return cls
    return "other"


def device_time_s(trace: Trace, patterns=None) -> float:
    """Summed device time of the operations whose names hold one of
    ``patterns`` (all operations where None)."""
    return sum(e - s for n, s, e in trace.ops
               if patterns is None or matches(n, patterns)) / 1e6


def class_time_s(trace: Trace, classes, wanted) -> float:
    """Summed device time of the operations in the classes ``wanted``."""
    return sum(e - s for n, s, e in trace.ops
               if kernel_class(n, classes) in wanted) / 1e6


def top_device_ops(trace: Trace, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    by = collections.Counter()
    for n, s, e in trace.ops:
        by[n] += (e - s) / 1e6
    return [[n, t] for n, t in by.most_common(top)]


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """[host activity, seconds] of the device's idle time inside the window,
    each gap named by the innermost host operation running at its middle,
    summed by name, longest first."""
    lo, hi = trace.window_us
    busy = merged([(n, max(s, lo), min(e, hi)) for n, s, e in trace.ops
                   if e > lo and s < hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    host = sorted(trace.host, key=lambda iv: iv[1])
    starts = [iv[1] for iv in host]
    by = collections.Counter()
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        # host operations nest: the innermost one around ``mid`` is the
        # latest-starting one that has not ended
        name = "(no host operation)"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][2] > mid:
                name = host[i][0]
                break
        by[name] += (e - s) / 1e6
    return [[n, t] for n, t in by.most_common(top)]
