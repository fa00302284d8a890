"""e2e_img_per_s: faces generated, inverted and ranked per second, over all
the window's calls and all its time."""


def read(run):
    return run.units / run.window_s
