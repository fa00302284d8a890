"""g_step_ms.train: device ms of the ``gr.train.g_step`` spans per traced
batch (G and D forward and backward on a full batch, G's update)."""
from portbench import spans


def read(run):
    times = spans.device_ms(run, "gr.train.g_step")
    return None if times is None else sum(times) / run.trace.steps
