#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result as one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number that
decided ``correct`` beside its limit); the last lines of standard error are
those numbers too. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics. The run fails, and prints no result,
without a CUDA card, with fewer cards than the cell asks for, or when a
module of JAX or of the JAX package was loaded.

``--control`` runs the cell's control in place of the program (the int8
legs of the fused program; the reference in float8 for the refinement and
the training step), which has to come out not correct.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# a Triton kernel's compile cache, should the port build one, stays inside
# the checkout at a fixed path (the CUDA kernels' is build/kernels/)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    chips = next(w["chips"] for w in harness.spec(ROOT)["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), root=ROOT, t_start=T_START,
                         control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
