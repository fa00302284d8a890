"""Export a serving artifact: a weights-baked ``torch.export`` program over
the port's kernels, the counterpart of ganreverser_tpu/cli/export.py.

A checkpoint's fast forward is prepared once (BatchNorm folded, weights
laid out as the kernels read them), traced at a static batch and saved
with its manifest (io/serving.py); any process that imports
``ganreverser_tpu_torch.io.serving`` loads and runs it, with no model
code, checkpoint or config.

    # the R inversion program, batch 256, bf16, checked against the live one
    python -m ganreverser_tpu_torch.cli.export --G logs/adversarial \\
        --save logs --out logs/serve_invert --what invert --batch 256 \\
        --compute_dtype bfloat16 --check

    # the fused generate -> invert -> top-k program at a fixed N
    python -m ganreverser_tpu_torch.cli.export --G logs/adversarial \\
        --save logs --out logs/serve_e2e --what e2e --N 10240 --batch 128 \\
        --compute_dtype bfloat16 --check

``--what invert`` bakes the fast R (kernel B; JAX bakes the module R),
``generate`` the fast G with U's fused head (kernels U and U's head; JAX
bakes its XLA fast G), ``e2e`` the fused program of analysis/e2e.py on
those legs (U, U's head, B, C). ``--int8`` swaps in the int8 legs
(models/fastpath.py: kernels Q1-Q4). The program is traced on the device
the command runs on (the card, unless GANREVERSER_PLATFORM=cpu), so an
artifact meant for the card holds the kernels' weight layouts. The
platforms are ``cuda`` and ``cpu``; ``tpu`` is refused (ROADMAP.md, queue
C). ``--check`` loads the artifact and holds its float outputs on one
seeded batch to the live program's: within 1e-3 x max(1, scale), 5e-2
under ``--int8`` (a value near a quantisation boundary may flip a whole
int8 level), JAX's tolerances.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..analysis.e2e import fast_legs, make_e2e_forward
from ..io import checkpoint as ckpt
from ..io.serving import (PLATFORMS, PROGRAM, check_platforms,
                          load_serving_program, save_serving_program)
from ..models import bridge
from . import common


def max_float_error(got, want) -> tuple:
    """(max |got - want|, max |want|) over the float tensors of two outputs
    (a tensor, or a tuple or list of them); integer ones (top-k indices,
    whose order among tied scores may differ) are left out, as the JAX
    check leaves them."""
    got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    pairs = [(a.float(), b.float()) for a, b in zip(got, want)
             if b.is_floating_point()]
    err = max((a - b).abs().max().item() for a, b in pairs)
    scale = max(b.abs().max().item() for _, b in pairs)
    return err, scale


def main(argv=None) -> dict:
    """Export (and with ``--check`` check) one artifact; returns its
    directory, manifest, the export seconds, its size in bytes and, with
    ``--check``, the check's error and scale."""
    p = argparse.ArgumentParser(
        description="export a serving artifact (a weights-baked "
                    "torch.export program, io/serving.py)")
    p.add_argument("--G", default="logs/adversarial",
                   help="G checkpoint (geometry is inherited from it, "
                        "like apply_r.lua:59-75)")
    p.add_argument("--R", default="",
                   help="R checkpoint (default derived from G's geometry)")
    p.add_argument("--save", default="logs",
                   help="directory with checkpoints")
    p.add_argument("--out", required=True,
                   help="artifact directory to write")
    p.add_argument("--what", default="invert",
                   choices=("invert", "generate", "e2e"),
                   help="program to export: invert = images->z (the "
                        "headline workload, apply_r.lua:143-153); "
                        "generate = z->images (fast decoder); e2e = the "
                        "fused generate->invert->top-k pipeline "
                        "(analysis/e2e.py)")
    p.add_argument("--batch", type=int, default=256,
                   help="static batch size of the exported program")
    p.add_argument("--N", type=int, default=10000,
                   help="static corpus size for --what e2e")
    p.add_argument("--k", type=int, default=100,
                   help="top-k for --what e2e")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight+activation paths (ops/quant.py)")
    p.add_argument("--platforms", default=",".join(PLATFORMS),
                   help="comma-separated device types the artifact is for: "
                        "cuda, cpu")
    p.add_argument("--compute_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and compare one random "
                        "batch against the live program on the local "
                        "device")
    args = p.parse_args(argv)
    try:
        platforms = check_platforms(s.strip() for s in
                                    args.platforms.split(",") if s.strip())
    except ValueError as e:
        sys.exit(f"[export] --platforms {args.platforms}: {e} (ROADMAP.md, "
                 "queue C)")

    device = common.resolve_device()
    dtype = common.compute_dtype(args)
    g_tree, g_cfg, _ = ckpt.load_checkpoint(args.G)
    noise_dim = g_cfg["noiseDim"]
    noise_method = g_cfg["noiseMethod"]
    colorspace = g_cfg["colorSpace"]
    h, w = g_cfg["height"], g_cfg["width"]
    c = 1 if colorspace == "y" else 3
    dims = (c, h, w)
    g_vars = bridge.to_torch({"params": g_tree["G"]["params"],
                              "state": g_tree["G"]["state"]}, device)

    def load_r():
        r_path = args.R or ckpt.r_name(args.save, c, h, w, noise_dim,
                                       noise_method, False)
        r_tree, _, _ = ckpt.load_checkpoint(r_path)
        return bridge.to_torch({"params": r_tree["R"]["params"],
                                "state": r_tree["R"]["state"]}, device)

    meta = {"what": args.what, "height": h, "width": w, "channels": c,
            "noiseDim": noise_dim, "noiseMethod": noise_method,
            "colorSpace": colorspace, "batch": args.batch,
            "compute_dtype": args.compute_dtype, "int8": bool(args.int8),
            "G": args.G}
    gen = torch.Generator(device=device).manual_seed(0)
    legs = fast_legs(dims, noise_dim, noise_method, dtype, int8=args.int8)

    with torch.inference_mode(False), torch.no_grad():
        if args.what == "generate":
            forward, variables = legs["g_apply"], g_vars
            example = (torch.randn(args.batch, noise_dim, generator=gen,
                                   device=device),)
        elif args.what == "invert":
            forward, variables = legs["r_apply"], load_r()
            example = (torch.rand(args.batch, h, w, c, generator=gen,
                                  device=device).to(dtype),)
        else:  # e2e
            forward = make_e2e_forward(None, None, batch_size=args.batch,
                                       k=args.k, **legs)
            variables = (g_vars, load_r())
            meta["N"] = args.N
            meta["k"] = args.k
            example = (torch.randn(args.N, noise_dim, generator=gen,
                                   device=device),)
        prepared = forward.prepare(variables)

        def fn(*xs):  # the weights baked: prepared once, closed over
            return forward.run(prepared, *xs)

        t0 = time.perf_counter()
        save_serving_program(args.out, fn, example, meta, platforms)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(args.out, PROGRAM))
        print(f"[export] wrote {args.out} ({args.what}"
              f"{', int8' if args.int8 else ''}, platforms="
              f"{','.join(platforms)}, {size / 1e6:.1f} MB) in "
              f"{export_s:.1f} s")
        result = {"out": args.out, "meta": meta, "export_s": export_s,
                  "bytes": size}
        if not args.check:
            return result
        if device.type not in platforms:
            sys.exit(f"[export] --check: local device {device.type} not in "
                     f"artifact platforms {platforms}")
        call, _ = load_serving_program(args.out, device)
        err, scale = max_float_error(call(*example), fn(*example))
    tol = (0.05 if args.int8 else 1e-3) * max(1.0, scale)
    if not err < tol:
        sys.exit(f"[export] check failed: max float |artifact - live| = "
                 f"{err:.3e} >= {tol:.3e} (scale {scale:.2e})")
    print(f"[export] check ok: max float |artifact - live| = {err:.3e} "
          f"(scale {scale:.2e})")
    result.update(check_err=err, check_scale=scale)
    return result


if __name__ == "__main__":
    main()
