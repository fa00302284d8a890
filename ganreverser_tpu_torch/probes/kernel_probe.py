"""Backend probe of the hand-written kernels — the counterpart of
benchmarks/tpu_pallas_probe.py: the smallest kernels first (kernel B9's
+1 on one block, x2 on a grid of blocks, a bf16 product on the tensor
cores), then kernel U at (4,8,8,128), each held to its plain version
(exactly, and U within 1e-2 of its scale in bf16). One line per probe,
``[probe] <name>: OK <first values>`` or ``FAIL <error>``; the exit code
is 1 when any probe failed.

Usage: python -m ganreverser_tpu_torch.probes.kernel_probe [--cpu]
"""
from __future__ import annotations

import sys
import traceback

import torch

from ..ops import probe_kernels as pk
from ..ops.upsample_conv_kernel import (upsample2_conv3x3_bn_act,
                                        upsample2_conv3x3_bn_act_plain)
from . import device_name, probe_device


def _probe(name: str, fn) -> bool:
    try:
        out, ref, tol = fn()
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        err = (out.float() - ref.float()).abs().max().item()
        if out.shape != ref.shape or not err <= tol:
            raise AssertionError(f"max |kernel - plain| {err} > {tol}")
        print(f"[probe] {name}: OK {out.flatten()[:2].tolist()}", flush=True)
        return True
    except Exception as e:  # noqa: BLE001 — a probe reports and goes on
        msg = str(e).splitlines()[0][:160] if str(e) else ""
        print(f"[probe] {name}: FAIL {type(e).__name__}: {msg}", flush=True)
        traceback.print_exc()
        return False


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = probe_device(argv)
    print(f"[probe] device: {device_name(dev)}", flush=True)
    bf16 = torch.bfloat16

    def trivial():
        x = torch.zeros((8, 128), device=dev)
        return pk.add_one(x), pk.add_one_plain(x), 0.0

    def gridded():
        x = torch.ones((4, 256, 128), device=dev)
        return pk.times_two(x), pk.times_two_plain(x), 0.0

    def with_dot():
        a = torch.ones((128, 128), dtype=bf16, device=dev)
        return pk.dot_bf16(a, a), pk.dot_bf16_plain(a, a), 0.0

    def upsample_tiny():
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((4, 8, 8, 128), generator=gen, device=dev).to(bf16)
        k = torch.full((3, 3, 128, 128), 0.01, device=dev)
        s, b = torch.ones(128, device=dev), torch.zeros(128, device=dev)
        ref = upsample2_conv3x3_bn_act_plain(x, k, s, b)
        return (upsample2_conv3x3_bn_act(x, k, s, b), ref,
                1e-2 * max(1.0, ref.float().abs().max().item()))

    results = [_probe(name, fn) for name, fn in (
        ("trivial_add", trivial), ("gridded", gridded),
        ("tensor_core_dot", with_dot), ("upsample_kernel_tiny",
                                        upsample_tiny))]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
