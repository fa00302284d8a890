"""optim_ms.train: device time of the optimizer layer (adam's and the
penalties' ``torch._foreach_*`` kernels) per traced batch."""
from portbench import tracing


def read(run):
    if run.trace is None:
        return None
    t = tracing.device_time_s(run.trace, run.cell.kernels["optimizer"])
    return 1e3 * t / run.trace.steps if t > 0 else None
