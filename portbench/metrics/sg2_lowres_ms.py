"""sg2_lowres_ms: the mean device ms a forward of StyleGAN2's mapping
(``gr.sg2.mapping``) and its synthesis blocks from 4 x 4 to 64 x 64
(``gr.sg2.b4`` ... ``gr.sg2.b64``): the 512-channel half, bound by
compute. None where a span is missing."""
from portbench import spans

BLOCKS = ("gr.sg2.mapping", "gr.sg2.b4", "gr.sg2.b8", "gr.sg2.b16",
          "gr.sg2.b32", "gr.sg2.b64")


def read(run):
    times = [spans.device_ms(run, name) for name in BLOCKS]
    if any(t is None for t in times):
        return None
    return sum(map(sum, times)) / len(times[0])
