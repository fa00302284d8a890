"""e2e_call_p95_ms: the 95th percentile of the window's calls, each timed on
the host from dispatch to ``synchronize()``."""
import statistics


def read(run):
    if not run.step_s or len(run.step_s) < 20:
        return None
    return 1e3 * statistics.quantiles(run.step_s, n=20)[-1]
