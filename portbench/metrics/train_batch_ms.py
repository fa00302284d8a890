"""train_batch_ms: the window's time over its adversarial batches (a D step
and a G step each)."""


def read(run):
    return 1e3 * run.window_s / run.units
