"""mfu.<cell kind>: the entry's necessary operations (the driver's
``counts``: the fused program's, G's forward and input gradient at every
refinement step, the D and G steps of training) at the window's rate of
steps, as a share of the card's bf16 peak."""
from portbench.readers import mfu


def read(run):
    return mfu(run)
