"""conv_share.refine: device time of cuDNN's convolution kernels over all
device time of the traced window."""
from portbench.readers import class_share


def read(run):
    return class_share(run, ("convolution (cuDNN)",))
