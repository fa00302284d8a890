"""Probe of kernel B7: a conv followed by a training BatchNorm and ReLU,
with the statistics taken in the conv's pass — the counterpart of
benchmarks/convbn_probe.py.

  baseline: the plain conv (f32 sums) -> batch mean / variance (two more
            reads of y) -> normalise -> ReLU
  fused:    conv_stats (kernel B7: y written once, its per-channel sum and
            sum of squares from the accumulators) -> normalise -> ReLU

Shape: G3's 3x3 256 -> 128 conv at 64x64, batch 256, bf16 (the largest
BatchNorm'd activation of a D step's G forward); ``--smoke`` takes
(4,8,8,16) -> 32 in f32. The two variants are held to each other (mean
and variance within 5e-3, the output within 0.1 in bf16 and 1e-3 in f32,
as the JAX probe holds them) before anything is timed; one JSON line per
variant, then the speedup.

Usage: python -m ganreverser_tpu_torch.probes.convbn [--cpu] [--smoke]
"""
from __future__ import annotations

import json
import sys

import torch

from ..ops.conv_stats_kernel import conv_stats
from ..ops.upsample_conv import conv_nhwc
from . import device_name, probe_device, time_ms

EPS = 1e-5


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = probe_device(argv)
    if "--smoke" in argv:
        n, h, w, ci, co, dtype = 4, 8, 8, 16, 32, torch.float32
    else:
        n, h, w, ci, co, dtype = 256, 64, 64, 256, 128, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    x = (0.5 * torch.randn((n, h, w, ci), generator=gen, device=dev)).to(dtype)
    k9 = (0.05 * torch.randn((3, 3, ci, co), generator=gen,
                             device=dev)).to(dtype)
    gamma = 0.5 + torch.rand(co, generator=gen, device=dev)
    beta = 0.1 * torch.randn(co, generator=gen, device=dev)
    cnt = n * h * w

    def finish(y, mean, var):
        inv = gamma * torch.rsqrt(var + EPS)
        out = torch.clamp_min(y * inv + (beta - mean * inv), 0.0)
        return out.to(dtype), mean, var

    def baseline():
        y = conv_nhwc(x, k9, 1, dtype)
        mean = y.mean(dim=(0, 1, 2))
        return finish(y, mean, (y * y).mean(dim=(0, 1, 2)) - mean * mean)

    def fused():
        y, s, sq = conv_stats(x, k9)
        mean = s / cnt
        return finish(y, mean, sq / cnt - mean * mean)

    ob, mb, vb = baseline()
    of, mf, vf = fused()
    torch.testing.assert_close(mf, mb, rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(vf, vb, rtol=5e-3, atol=5e-3)
    err = (of.float() - ob.float()).abs().max().item()
    limit = 0.1 if dtype == torch.bfloat16 else 1e-3
    if not err < limit:
        raise AssertionError(f"convbn: fused vs baseline max |err| {err} "
                             f">= {limit}")
    print(f"[convbn] parity ok (max |err| {err:.4g})", file=sys.stderr)
    del ob, mb, vb, of, mf, vf

    dname = str(dtype).split(".")[-1]
    records = []
    for name, fn in (("plain conv+trainBN+relu", baseline),
                     ("fused conv+stats kernel", fused)):
        rec = {"metric": f"{name} {ci}->{co} @{h}x{w} b{n} {dname}",
               "ms": time_ms(fn, dev, reps=3), "device": device_name(dev),
               "max_abs_err": err,
               "note": "fwd-only probe; fused saves the statistics' reads "
                       "of the conv output"}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    t_base, t_fused = records[0]["ms"], records[1]["ms"]
    print(json.dumps({"metric": "fused/plain speedup",
                      "value": (t_base / t_fused if t_fused else None)}),
          flush=True)
    return records


if __name__ == "__main__":
    main()
