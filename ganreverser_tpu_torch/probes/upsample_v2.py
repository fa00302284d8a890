"""Probe of kernel B8: kernel U against its channel-stacked variant
(one K loop of 4*Ci per phase) and the plain dilated form — the
counterpart of benchmarks/tpu_upsample_v2.py, whose variant never
compiled on the TPU.

For G3's two stages, (256,16,16,512) -> 256 and (256,32,32,256) -> 128 in
bf16 (``--smoke``: batch 4 at (4,4,16) -> 8 and (8,8,8) -> 4 in f32), one
line each with the median times of v1 (kernel U), v2 (kernel B8) and the
dilated form (ops/upsample_conv.py's stride-2 transposed conv, then
ReLU), and the max error of v2 against v1, which must stay
within 3e-2 of the output's scale in bf16 (v1 rounds each tap to bf16
before summing a phase's taps, v2 sums them in f32 first) and 1e-4 in f32.

Usage: python -m ganreverser_tpu_torch.probes.upsample_v2 [--cpu] [--smoke]
"""
from __future__ import annotations

import json
import sys

import torch

from ..ops.upsample_conv import upsample2_conv3x3_dilated
from ..ops.upsample_conv_kernel import upsample2_conv3x3_bn_act
from ..ops.upsample_v2_kernel import upsample_v2
from . import device_name, probe_device, time_ms

SHAPES = ((16, 512, 256), (32, 256, 128))
SMOKE_SHAPES = ((4, 16, 8), (8, 8, 4))


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = probe_device(argv)
    smoke = "--smoke" in argv
    n, dtype = (4, torch.float32) if smoke else (256, torch.bfloat16)
    dname = str(dtype).split(".")[-1]
    records = []
    for h, ci, co in (SMOKE_SHAPES if smoke else SHAPES):
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((n, h, h, ci), generator=gen, device=dev).to(dtype)
        kern = 0.04 * torch.randn((3, 3, ci, co), generator=gen, device=dev)
        scale = torch.ones(co, device=dev)
        shift = torch.zeros(co, device=dev)

        def v1():
            return upsample2_conv3x3_bn_act(x, kern.to(dtype), scale, shift,
                                            act="relu")

        def v2():
            return upsample_v2(x, kern, scale, shift)

        def dilated():
            return torch.clamp_min(upsample2_conv3x3_dilated(
                x, kern, shift, dtype), 0.0)

        ref = v1().float()
        err = (v2().float() - ref).abs().max().item()
        tol = (3e-2 if dtype == torch.bfloat16 else 1e-4) * max(
            1.0, ref.abs().max().item())
        del ref
        rec = {"metric": f"upsample {n}x{h}x{h}x{ci}->{co} {dname}",
               "v1_ms": time_ms(v1, dev), "v2_ms": time_ms(v2, dev),
               "dilated_ms": time_ms(dilated, dev), "max_err": err,
               "tol": tol, "device": device_name(dev)}
        fmt = (lambda t: "not timed" if t is None else f"{t:.3f} ms")
        print(f"{n}x{h}x{h}x{ci}->{co}: v1 {fmt(rec['v1_ms'])} | v2(cat-K) "
              f"{fmt(rec['v2_ms'])} | dilated {fmt(rec['dilated_ms'])} | "
              f"max_err {err}", flush=True)
        print(json.dumps(rec), flush=True)
        if not err <= tol:
            raise AssertionError(f"upsample_v2 vs U: max_err {err} > {tol}")
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
