"""d_step_ms.train: device ms of the ``gr.train.d_step`` spans per traced
batch (G's forward on the fake half, D's forward and backward, D's update,
the confusion counts)."""
from portbench import spans


def read(run):
    times = spans.device_ms(run, "gr.train.d_step")
    return None if times is None else sum(times) / run.trace.steps
