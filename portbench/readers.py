"""Arithmetic that several metric readers share."""
from __future__ import annotations

import sys

from . import tracing, work


def mfu(run):
    """The driver's necessary operations per step at the window's rate of
    steps, as a percentage of the card's bf16 peak (the configurations'
    compute type, so no precision can read above it)."""
    flops = run.counts["flops_per_step"] * run.steps / run.window_s
    print(f"[portbench] mfu against {work.PEAK_FLOPS:.4g} FLOP/s (bf16) on "
          f"{run.card['name']}, power limit {run.card['power_limit']}",
          file=sys.stderr)
    return 100.0 * flops / work.PEAK_FLOPS


def share(run, patterns):
    """Device time of the operations named by ``patterns`` over all device
    time of the traced window, in percent; None without a trace or where
    nothing matches."""
    if run.trace is None:
        return None
    part = tracing.device_time_s(run.trace, patterns)
    total = tracing.device_time_s(run.trace)
    return 100.0 * part / total if part > 0 else None


def class_share(run, classes):
    """As :func:`share`, for the classes of ``kernels.json``."""
    if run.trace is None:
        return None
    table = run.cell.kernels["classes"]
    part = tracing.class_time_s(run.trace, table, set(classes))
    total = tracing.device_time_s(run.trace)
    return 100.0 * part / total if part > 0 else None


def kernel_roofline(run):
    """Sum of the least times of the layers that the traced steps' hand-
    written kernels computed, over the sum of those kernels' device times,
    in percent. A kind of kernel counts where its names appear in the
    trace; a hand-written kernel the table does not know is named on
    standard error and counted in neither sum."""
    if run.trace is None:
        return None
    table = run.cell.kernels["handwritten"]
    bounds = run.counts["kernel_bounds_s"]
    known = [p for pats in table.values() for p in pats]
    unknown = sorted({n for n, _, _ in run.trace.ops
                      if tracing.matches(n, run.cell.kernels[
                          "handwritten_marks"]) and not tracing.matches(
                          n, known)})
    for name in unknown:
        print(f"[portbench] kernel_roofline: {name} is not in kernels.json, "
              "left out", file=sys.stderr)
    bound = time = 0.0
    for kind, pats in table.items():
        t = tracing.device_time_s(run.trace, pats)
        if t > 0:
            time += t
            bound += bounds[kind] * run.trace.steps
    return 100.0 * bound / time if time > 0 else None
