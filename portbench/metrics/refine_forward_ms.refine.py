"""refine_forward_ms.refine: mean device ms of a ``gr.refine.forward`` span
(G's forward and the loss at one adam step)."""
from portbench import spans


def read(run):
    times = spans.device_ms(run, "gr.refine.forward")
    return None if times is None else sum(times) / len(times)
