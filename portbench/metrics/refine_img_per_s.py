"""refine_img_per_s: faces whose latents were refined per second, over all
the window's chunks and all its time."""


def read(run):
    return run.units / run.window_s
