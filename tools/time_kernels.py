#!/usr/bin/env python3
"""Median wrapper times of the port's kernels at chip_smoke.py's phase-3
shapes, from one checkout, for A/B runs of two commits in one call.

    python3 tools/time_kernels.py [--root DIR] [--names a,b,...] [--reps N]

``--root`` is the checkout whose ``chip_smoke.py`` and
``ganreverser_tpu_torch`` are imported (default: this one), so an older
commit unpacked into a directory can be timed by the same script; its
kernels build into that checkout's ``build/kernels``. ``--names`` picks
kernels by their ``chip_smoke.kernel_cases`` name (default: conv_block,
upsample2_conv3x3_bn_act, conv3x3_bn_act, upsample2_conv3x3_head,
cosine_scores: B, U, B6, U's fused head, C). Each case runs in bf16 at
N = 256 (C at apply_r's N = 10,000): the median of ``--reps`` calls by CUDA
events (chip_smoke's ``time_ms``: the wrapper as a user calls it, weight
re-layout and padding included), and the device time per call of the
hand-written kernels it launched, from a torch.profiler trace of
``--reps`` calls: the device operations whose name holds one of ``DEVICE_KERNELS``
(the tensor-core kernels, the head's and C's second launches, and the
CUDA-core head and C of a checkout that predates their tensor-core
design). One JSON line per case with the card's name and power limit, then
one line with the sums per kernel. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_NAMES = ("conv_block,upsample2_conv3x3_bn_act,conv3x3_bn_act,"
                 "upsample2_conv3x3_head,cosine_scores")
DEVICE_KERNELS = ("wgmma_kernel", "finish_kernel", "conv3x3_head_kernel",
                  "cosine_scores_kernel")


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` in kernels whose name holds one of
    ``DEVICE_KERNELS``, from a torch.profiler trace of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if any(k in ev.key for k in DEVICE_KERNELS):
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return total / reps / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--names", default=DEFAULT_NAMES)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    names = args.names.split(",")
    sums = dict.fromkeys(names, 0.0)
    dev_sums = dict.fromkeys(names, 0.0)
    for name, label, make in chip_smoke.kernel_cases(dev, chip_smoke.N_CHECK,
                                                     chip_smoke.N_MAIN):
        if name not in sums:
            continue
        case = make(torch.bfloat16)
        ms = chip_smoke.time_ms(case["kernel"], reps=args.reps)
        dms = device_ms(case["kernel"], args.reps)
        sums[name] += ms
        dev_sums[name] += dms
        print(json.dumps({"root": root, "name": name, "label": label,
                          "dtype": "bfloat16", "ms": ms, "device_ms": dms,
                          "card": card}))
        del case
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "sum_ms": sums,
                      "sum_device_ms": dev_sums, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
