"""span_idle_ms.<cell kind>: the device's idle ms per traced step whose
gap lies under one of the program's spans (``gr.*``); the rest of the idle
is the harness's or the driver's."""
from portbench import spans


def read(run):
    by = spans.idle_s(run)
    if by is None:
        return None
    return 1e3 * sum(by.values()) / run.trace.steps
