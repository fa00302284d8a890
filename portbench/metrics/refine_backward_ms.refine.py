"""refine_backward_ms.refine: mean device ms of a ``gr.refine.backward``
span (the gradient to z at one adam step)."""
from portbench import spans


def read(run):
    times = spans.device_ms(run, "gr.refine.backward")
    return None if times is None else sum(times) / len(times)
