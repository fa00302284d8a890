#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from: one cell run
in one process on many seeds, and its control on others, each with a short
window; from the root of a checkout, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 3] [--out file.jsonl] \
        [--fault train_half_batch]

Each run prints one JSON line (the seed, whether it was the control, the
compared numbers, the end-to-end metrics); the last lines give, for each
compared number, the largest reading of the program's seeds and the
smallest of the control's.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="a fault of portbench/faults.py planted in the "
                    "program for every run, e.g. train_half_batch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    runs = ([(int(s), False) for s in args.seeds.split(",") if s]
            + [(int(s), True) for s in args.control_seeds.split(",") if s])
    sound, control = {}, {}
    out = open(args.out, "a") if args.out else None
    for seed, is_control in runs:
        t = time.perf_counter()
        with (faults.planted(getattr(faults, args.fault)) if args.fault
              else contextlib.nullcontext()):
            r = harness.run(args.workload, seed, args.seconds, False,
                            root=ROOT, t_start=t, control=is_control,
                            readings=True)
        line = {"workload": args.workload, "seed": seed,
                "control": is_control, "fault": args.fault,
                "checks": r["readings"],
                "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        table = control if is_control else sound
        for k, v in line["checks"].items():
            table.setdefault(k, []).append(v)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    for k in sorted(set(sound) | set(control)):
        print(f"{args.workload} {k}: program max {max(sound.get(k, [0]))!r} "
              f"over {len(sound.get(k, []))} seeds; control min "
              f"{min(control.get(k, [float('nan')]))!r} over "
              f"{len(control.get(k, []))} seeds", flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
