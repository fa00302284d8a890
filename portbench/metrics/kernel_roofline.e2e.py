"""kernel_roofline.e2e: the least time of the work the port's hand-written
kernels compute over their device time in the traced calls (the kinds of
``kernels.json``'s ``handwritten`` table and their bounds in
drivers/e2e.py's ``counts``)."""
from portbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run)
