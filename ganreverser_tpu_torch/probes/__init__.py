"""Probe entry points of the kernels no CLI path runs — the counterparts of
benchmarks/convbn_probe.py (kernel B7), benchmarks/tpu_upsample_v2.py (B8)
and benchmarks/tpu_pallas_probe.py (B9). Each runs on the card unless given
``--cpu``, where the wrappers take their plain versions and nothing is
timed."""
from __future__ import annotations

import statistics
import sys

import torch


def probe_device(argv) -> torch.device:
    """The CPU with ``--cpu``; else the current CUDA device, and an exit
    with a message when there is none (a probe meant for the card never
    carries on on the CPU)."""
    if "--cpu" in argv:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        sys.exit("this probe runs on an NVIDIA GPU (or pass --cpu)")
    return torch.device("cuda", torch.cuda.current_device())


def time_ms(fn, dev: torch.device, reps: int = 5, warmup: int = 1):
    """Median device time of one call of ``fn`` in ms, by CUDA events;
    None on the CPU (a CPU time says nothing about the card)."""
    if dev.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
