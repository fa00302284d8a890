"""setup_s: process start to the first timed step (imports, the kernel
library's build or load, weights, set-up of the entry, its first calls)."""


def read(run):
    return run.setup_s
