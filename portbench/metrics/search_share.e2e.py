"""search_share.e2e: device time of the searches (kernel C and its finish
launch, the top-k selection) over all device time of the traced window."""
from portbench.readers import share


def read(run):
    return share(run, run.cell.kernels["search"])
