"""update_ms.train: device ms of the ``gr.optim.update`` spans per traced
batch (D's and G's: the penalties and adam)."""
from portbench import spans


def read(run):
    times = spans.device_ms(run, "gr.optim.update")
    return None if times is None else sum(times) / run.trace.steps
