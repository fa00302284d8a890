"""idle_share.<cell kind>: the device's idle share of the traced window,
1 - (the union of its device operations' intervals) / (the window)."""
from portbench import tracing


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * tracing.idle_share(run.trace)
