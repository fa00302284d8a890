"""graph_launch_ms.e2e: host ms per traced call inside the span
``gr.program.replay`` (the CUDA graph's launch and the launch counters)."""
from portbench import spans


def read(run):
    ms = spans.host_ms(run, "gr.program.replay")
    return None if ms is None else ms / run.trace.steps
