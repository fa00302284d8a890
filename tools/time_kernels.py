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
cosine_scores: B, U, B6, U's fused head, C), by their
``chip_smoke.quant_cases`` name (``quant_conv3x3_same``,
``quant_upsample2_conv3x3``, ``quant_dense``, ``quant_act``: Q1 at R's
six layers and G's output conv, Q2 at G's two stages, Q3 at its three
layers, Q4's two launches at the checkout's sizes, int8, as phase 10 times
them: with the max where a quantiser follows, in a checkout whose
producers take it), or one of three cases
built here from entry points every checkout of the port has:

- ``fused_dropout`` (B5): the bf16 forward at each of chip_smoke's
  ``DROPOUT_STEP_SHAPES`` (one R step's six dropouts);
- ``kmeans_lloyd`` (K): ``analysis.kmeans.kmeans`` at (10,000, 100), 15
  iterations, K = 20 and K = 256 (one launch, or a loop of steps in a
  checkout that predates the one-launch design);
- ``r_step``: one warm R train step, b256 bf16 ``--dropout kernel``
  (chip_smoke's ``step_times``: the median of its 20 steps is the case's
  time, and its device time is B5's share);
- ``probes`` (B9): ``add_one`` on (8,128), ``times_two`` on (4,256,128)
  and ``dot_bf16`` on (128,128)^2, chip_smoke's phase-3 shapes (their
  device time is the ``probe_`` kernels');
- ``approx_topk`` (S): ``approx_topk`` on kernel C's f32 scores at
  chip_smoke's ``APPROX_SHAPES`` x ``APPROX_RECALLS`` and
  ``APPROX_LARGE``, phase 11's shapes (its device time is the
  ``approx_topk_`` kernels': one a call, or a checkout's several);
- ``e2e_approx`` and ``e2e_exact``: one call of the fused program
  (``analysis.e2e.make_e2e_program``, a CUDA graph replay) at
  chip_smoke's phase-11 arguments, N = ``E2E_N``, batch
  ``E2E_BATCHES[0]``, k = ``E2E_K``, pixel_k = ``E2E_PIXEL_K``, on phase
  8's x3 weights, with ``approx`` at ``APPROX_R`` and without (the time
  of a call gives its img/s; its device time is every hand-written
  kernel's in it).

Each kernel case runs in bf16 at N = 256 (C at apply_r's N = 10,000): the
median of ``--reps`` calls by CUDA events (chip_smoke's ``time_ms``: the
wrapper as a user calls it, weight re-layout and padding included), and
the device time per call of the hand-written kernels it launched, and
their launches a call, from a torch.profiler trace of ``--reps`` calls:
the device operations whose name holds one of ``DEVICE_KERNELS`` (the
tensor-core kernels, the head's and
C's second launches, the CUDA-core head and C of a checkout that predates
their tensor-core design, B5 and K, Q1-Q3 on the int8 tensor cores or
their __dp4a kernels in a checkout before that, Q3's sum or finish
launch, Q4's kernels, S's). One JSON line per case with the
card's name and power limit, then one line with the sums per kernel.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys

DEFAULT_NAMES = ("conv_block,upsample2_conv3x3_bn_act,conv3x3_bn_act,"
                 "upsample2_conv3x3_head,cosine_scores")
DEVICE_KERNELS = ("wgmma_kernel", "finish_kernel", "conv3x3_head_kernel",
                  "cosine_scores_kernel", "fused_dropout", "kmeans_",
                  "probe_", "_s8_kernel", "quant_tapconv_kernel",
                  "quant_dense", "quant_a", "approx_topk_")
QUANT_NAMES = ("quant_conv3x3_same", "quant_upsample2_conv3x3",
               "quant_dense", "quant_act")
KMEANS_CASE = (10_000, 100, 15)   # N, D (noise 100), Lloyd iterations


def local_cases(dev, names):
    """(name, label, fn) for the cases built here."""
    import torch
    import chip_smoke
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 21)
    if "fused_dropout" in names:
        from ganreverser_tpu_torch.ops import dropout_kernel as dk
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        for shape in chip_smoke.DROPOUT_STEP_SHAPES:
            x = torch.randn(shape, device=dev, generator=gen).to(
                torch.bfloat16)
            yield ("fused_dropout", str(shape),
                   lambda x=x: dk.fused_dropout(x, seed, 0.5))
    if "kmeans_lloyd" in names:
        from ganreverser_tpu_torch.analysis.kmeans import kmeans
        n, d, iters = KMEANS_CASE
        x = torch.randn(n, d, device=dev, generator=gen)
        for k in (20, 256):
            idx = torch.randperm(n, device=dev, generator=gen)[:k]
            yield ("kmeans_lloyd", f"({n},{d}) K={k}, {iters} iterations",
                   lambda k=k, idx=idx: kmeans(x, k, iters, init_idx=idx))
    if "probes" in names:
        from ganreverser_tpu_torch.ops import probe_kernels as pk
        x = torch.randn(8, 128, device=dev, generator=gen)
        x3 = torch.randn(4, 256, 128, device=dev, generator=gen)
        a, b = (torch.randint(-3, 4, (128, 128), device=dev,
                              generator=gen).to(torch.bfloat16)
                for _ in range(2))
        for label, fn in (("add_one (8,128)", lambda: pk.add_one(x)),
                          ("times_two (4,256,128)",
                           lambda: pk.times_two(x3)),
                          ("dot_bf16 (128,128)^2",
                           lambda: pk.dot_bf16(a, b))):
            yield ("probes", label, fn)
    if "approx_topk" in names:
        from ganreverser_tpu_torch.ops import approx_topk_kernel as S
        from ganreverser_tpu_torch.ops import topk_kernel
        cases = [(*shape, r) for shape in chip_smoke.APPROX_SHAPES
                 for r in chip_smoke.APPROX_RECALLS]
        for label, q, n, d, k, r in cases + [chip_smoke.APPROX_LARGE]:
            emb = torch.randn(n, d, device=dev, generator=gen).to(
                torch.bfloat16)
            scores = topk_kernel.cosine_scores(emb, torch.arange(q,
                                                                 device=dev))
            yield ("approx_topk", f"{label} Q={q} N={n} k={k} r={r}",
                   lambda s=scores, k=k, r=r: S.approx_topk(s, k, r))
    if "e2e_approx" in names or "e2e_exact" in names:
        from ganreverser_tpu_torch.analysis import e2e
        G, R, _, _, gv2, rv2, z = chip_smoke.e2e_inputs(dev)
        for name, approx in (("e2e_approx", True), ("e2e_exact", False)):
            if name not in names:
                continue
            prog = e2e.make_e2e_program(
                G, R, batch_size=chip_smoke.E2E_BATCHES[0],
                k=chip_smoke.E2E_K, needle_chunk=chip_smoke.E2E_CHUNK,
                approx=approx, recall_target=chip_smoke.APPROX_R,
                pixel_k=chip_smoke.E2E_PIXEL_K,
                **e2e.fast_legs(chip_smoke.DIMS, chip_smoke.NOISE_DIM,
                                "normal"))
            prog(gv2, rv2, z)
            yield (name, f"N={chip_smoke.E2E_N} batch "
                   f"{chip_smoke.E2E_BATCHES[0]} pixel_k "
                   f"{chip_smoke.E2E_PIXEL_K}",
                   lambda prog=prog: prog(gv2, rv2, z))
    if "r_step" in names:
        from ganreverser_tpu_torch.models import modules, zoo
        G = chip_smoke.make_calibrated_g(dev)
        Gb = zoo.create_G3(chip_smoke.DIMS, chip_smoke.NOISE_DIM,
                           torch.bfloat16).to(dev)
        Gb.load_state_dict(G.state_dict())
        R = modules.init_parameters(
            zoo.create_R(chip_smoke.DIMS, chip_smoke.NOISE_DIM, "normal",
                         dtype=torch.bfloat16, dropout_impl="kernel"),
            torch.Generator().manual_seed(chip_smoke.SEED + 22))
        yield ("r_step", "b256 bf16 --dropout kernel",
               lambda: chip_smoke.step_times(Gb, R.state_dict(), dev,
                                             "kernel"))


def device_ms(fn, reps: int, tries: int = 3):
    """(device time per call, launches per call) of ``fn`` in kernels whose
    name holds one of ``DEVICE_KERNELS``, from a torch.profiler trace of
    ``reps`` calls, traced again (up to ``tries`` times) while the trace
    holds a fraction of a launch a call: now and then a trace drops a
    launch (19 of 20 calls of a one-launch kernel, once in a
    chip_smoke.py run), which would read as a kernel launched less than
    once a call and a device time short of one launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if any(k in ev.key for k in DEVICE_KERNELS):
                total += getattr(ev, "device_time_total",
                                 getattr(ev, "cuda_time_total", 0.0))
                count += ev.count
        if count % reps == 0:
            break
    return total / reps / 1e3, count / reps


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
    kernel_cases = ((name, label, make)
                    for name, label, make in chip_smoke.kernel_cases(
                        dev, chip_smoke.N_CHECK, chip_smoke.N_MAIN)
                    if name in sums)
    quant_cases = ((name, label, make)
                   for name, label, make in (chip_smoke.quant_cases(
                       dev, chip_smoke.N_CHECK) if sums.keys() & set(
                           QUANT_NAMES) else ())
                   if name in sums)
    for name, label, fn in itertools.chain(
            ((n, lab, make(torch.bfloat16)["kernel"])
             for n, lab, make in kernel_cases),
            ((n, lab, make()["kernel"]) for n, lab, make in quant_cases),
            local_cases(dev, names)):
        if name == "r_step":  # a call is 3 warm-up + STEP_TIMES steps
            ms = statistics.median(fn())
            dms, kernels = device_ms(fn, 1)
            dms /= chip_smoke.STEP_TIMES + 3
        else:
            ms = chip_smoke.time_ms(fn, reps=args.reps)
            dms, kernels = device_ms(fn, args.reps)
        sums[name] += ms
        dev_sums[name] += dms
        dtype = ("f32 and bf16" if name == "probes" else
                 "float32" if name == "approx_topk" else
                 "int8" if name in QUANT_NAMES else "bfloat16")
        print(json.dumps({"root": root, "name": name, "label": label,
                          "dtype": dtype, "ms": ms, "device_ms": dms,
                          "kernels_per_call": kernels, "card": card}))
        del fn
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "sum_ms": sums,
                      "sum_device_ms": dev_sums, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
