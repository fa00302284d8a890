"""What the readers take from the program's spans (``gr.*``,
``ganreverser_tpu_torch/io/metrics.py::span``): their host ranges in the
traced window's trace, their device times from the program's store, and
the device's idle time under them.

Each function returns None where there is nothing of the kind to read: no
trace, a program that keeps no spans (``io.metrics`` without ``spans``) or
no span of the name; a renamed span reads None and fails nothing.
"""
from __future__ import annotations

import sys

from . import tracing

PREFIX = "gr."


def host_ms(run, name: str):
    """Summed host ms of the trace's ranges named ``name``."""
    if run.trace is None:
        return None
    times = [e - s for n, s, e in run.trace.host if n == name]
    return sum(times) / 1e3 if times else None


def device_ms(run, name: str):
    """The device ms of each span named ``name`` that the program kept in
    the traced window, as a list."""
    if run.trace is None:
        return None
    from ganreverser_tpu_torch.io import metrics
    spans = getattr(metrics, "spans", None)
    if spans is None:
        return None
    times = [s.device_ms for s in spans() if s.name == name]
    if not times or None in times:
        return None
    return times


def idle_s(run):
    """{span name: s} of the device's idle time inside the traced window,
    each gap given to the innermost ``gr.`` range at its middle
    (``tracing.idle_gaps``' rule, the host restricted to the program's
    spans); gaps under no span are left out. Named on standard error."""
    if run.trace is None or not run.trace.ops:
        return None
    host = [iv for iv in run.trace.host if iv[0].startswith(PREFIX)]
    if not host:
        return None
    gaps = tracing.idle_gaps(run.trace._replace(host=host), top=None)
    by = {n: s for n, s in gaps if n.startswith(PREFIX)}
    print("[portbench] idle under the program's spans: "
          + (", ".join(f"{n} {s:.6f} s" for n, s in by.items()) or "none"),
          file=sys.stderr)
    return by
