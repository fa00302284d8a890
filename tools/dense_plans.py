#!/usr/bin/env python3
"""Kernel Q3's device time at each column tile width BN, at the int8 legs'
three dense layers (G l0, R l27, R l31 at batch 256), for the choice that
``ops/quant.py::dense_plan`` makes.

    python3 tools/dense_plans.py [--reps N]

For each layer and each BN of 16, 32, 64 and 128: the plan at that BN
(``dense_plan_at``: its K splits by ``dense_splits``, its ring), the
kernel's output checked bitwise against the plain version, and the device
time per call (torch.profiler over ``--reps`` calls, the ``quant_dense``
kernels: the tile and, under a K split, the sum launch). The BN that
``dense_plan`` picks is marked. One line per case with the card's name
and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ganreverser_tpu_torch.ops import quant as Q  # noqa: E402

WIDTHS = (16, 32, 64, 128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_plans: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 42)
    c, h, w = cs.DIMS
    n = cs.N_CHECK
    layers = (("G l0", cs.NOISE_DIM, h * w * 32, "relu"),
              ("R l27", h * w * 8, 512, "elu"),
              ("R l31", 512, cs.NOISE_DIM, "none"))
    chosen = Q.dense_plan
    ok = True
    for label, k, m, act in layers:
        xq, xs = Q.quantize_plain(torch.randn(n, k, device=dev,
                                              generator=gen))
        wq, ws = Q.quantize_plain(torch.randn(k, m, device=dev,
                                              generator=gen), axis=(0,))
        b = torch.randn(m, device=dev, generator=gen)
        op = Q.dense_operand(wq)
        ref = Q.quant_dense_plain(xq, xs, wq, ws, b, act=act)
        pick = chosen(n, k, m)[0].bn
        for bn in WIDTHS:
            Q.dense_plan = lambda n_, k_, m_, bn=bn: Q.dense_plan_at(
                n_, k_, m_, bn)
            try:
                def call():
                    return Q.quant_dense(xq, xs, wq, ws, b, act=act,
                                         operand=op, with_max=True)
                same = torch.equal(call()[0], ref)
                ms = cs.device_ms(call, ("quant_dense",), reps=args.reps)
            finally:
                Q.dense_plan = chosen
            ok &= same
            plan, splits = Q.dense_plan_at(n, k, m, bn)
            print(f"[dense] {label} ({n},{k})x({k},{m}) BN {bn}"
                  f"{' (chosen)' if bn == pick else ''}: plan {tuple(plan)}"
                  f", {splits} K split(s), device {ms:.4f} ms, bitwise the "
                  f"plain version {same}  [{card}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
