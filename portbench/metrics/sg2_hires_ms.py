"""sg2_hires_ms: the mean device ms a forward of StyleGAN2's synthesis
blocks from 128 x 128 to 1024 x 1024 (``gr.sg2.b128`` ...
``gr.sg2.b1024``): 256 down to 32 channels over 16 K to 1 M pixels, where
the elementwise passes and the FIR filters weigh most. None where a span
is missing."""
from portbench import spans

BLOCKS = ("gr.sg2.b128", "gr.sg2.b256", "gr.sg2.b512", "gr.sg2.b1024")


def read(run):
    forwards = spans.device_ms(run, "gr.sg2.mapping")
    times = [spans.device_ms(run, name) for name in BLOCKS]
    if forwards is None or any(t is None for t in times):
        return None
    return sum(map(sum, times)) / len(forwards)
