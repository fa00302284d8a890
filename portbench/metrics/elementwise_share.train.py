"""elementwise_share.train: device time of elementwise, copy and cast, and
reduction kernels over all device time of the traced window."""
from portbench.readers import class_share


def read(run):
    return class_share(run, ("elementwise", "copy and cast", "reduction"))
