#!/usr/bin/env python3
"""Where the time of the port's main path goes on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/profile_port.py [--out build/profile]
                                  [--what all|apply_r|train|gan|distill]

With the models of chip_smoke.py (G3, R and the fixer-R at 3x64x64, noise
100, random weights from its seed), bf16, batch 256, N = 10,000, it prints
and writes to ``<out>/profile.txt``:

* ``[e2e]``: three warm runs of apply_r's stage ② (generate + invert) and
  stage ④ (both searches), wall time and img/s;
* ``[layer]``: G alone and R alone (median of 3), and each search alone;
* ``[trace]``: one warm stage ② + ④ under torch.profiler. Device busy time
  is the union of the intervals of every kernel, memcpy and memset in the
  exported trace (``<out>/trace_main_path.json``), so nothing is counted
  twice; the idle share is 1 - busy / wall. Then device time by class of
  operation (``kernel_class``: convolution, elementwise, copy and cast, ...)
  and by kernel name;
* ``[apply_r]``: the CLI's six stages with the fixer-R, once cold and once
  warm (each stage's seconds), then once more warm under torch.profiler
  (``<out>/trace_apply_r.json``): wall, device busy, idle share, device
  time by kernel name. The host's share (grids, JPEG files, the copy of the
  images) shows as device idle time;
* ``[native]``: cuDNN in bf16 on the tensor cores at the shapes of kernels
  B and U, for reference only (the conv output is rounded to bf16 before
  the epilogue, so it is not the kernels' function);
* ``[train]``: R's train step at batch 256, bf16, G3 as chip_smoke.py
  settles it, with ``--dropout kernel`` and with the plain masks: 10 warm
  steps under torch.profiler each (``<out>/trace_train_<impl>.json``):
  ms/step, device busy, idle share, device time by kernel name.

* ``[gan]``: one batch pair of adversarial training (a D step and a G
  step, train/adversarial.py) at batch 256, bf16, adam, G3 and D2 at
  3x64x64 with random weights from chip_smoke.py's seed: 10 warm pairs
  under torch.profiler (``<out>/trace_gan.json``): ms/pair, device busy,
  idle share, device time by class and by kernel name.

* ``[distill]``: ``cli.pretrain_prev`` as chip_smoke.py's phase 7 runs it
  (a random rgb G3 + D2 at 3x64x64 into yuv at 3x64x64, noise 100, batch
  64, bf16): 10 batches to warm up, then 20 under torch.profiler
  (``<out>/trace_distill.json``): ms/batch, device busy, idle share (the
  host hop for colour space and size, and the synthetic real images, show
  as idle time), device time by class and by kernel name.

``--what apply_r`` runs the ``[e2e]``, ``[layer]``, ``[trace]``,
``[apply_r]`` and ``[native]`` sections; ``--what train`` only ``[train]``;
``--what gan`` only ``[gan]``; ``--what distill`` only ``[distill]``;
``--what all`` every section.

Every line carries the card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ganreverser_tpu_torch.analysis.batched import forward_batched  # noqa: E402
from ganreverser_tpu_torch.analysis.pipeline import generate_and_invert  # noqa: E402
from ganreverser_tpu_torch.analysis.similarity import (  # noqa: E402
    cosine_topk, pixel_cosine_topk)
from ganreverser_tpu_torch.core.prng import noise_inputs, seeded_generator  # noqa: E402
from ganreverser_tpu_torch.models import bridge, fastpath  # noqa: E402

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# (class, substrings of a device operation's name); the first match wins
_CLASSES = (
    ("B5 dropout kernel", ("fused_dropout_kernel",)),
    ("kernels B, U, C, K", ("gr::",)),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "cudnn",
                             "nhwcAddPadding")),
    ("matmul (cuBLAS)", ("gemm", "cutlass")),
    ("optimizer and penalties (_foreach)", ("multi_tensor_apply",)),
    ("pooling", ("max_pool",)),
    ("reduction", ("reduce_kernel", "lpnorm")),
    ("copy and cast", ("copy", "Copy")),
    ("memcpy and memset", ("Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    """The class of a device operation, from its (demangled) name."""
    for cls, keys in _CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def device_intervals(trace_path: str):
    """(name, start_us, end_us) of every device operation in a Chrome trace
    exported by torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and str(e.get("cat", "")).lower()
            in _DEVICE_CATS]


def union_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((s, e) for _, s, e in intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarise_trace(prof, trace_path: str, wall_us: float, tag: str, log,
                    card: str, top: int = 20) -> bool:
    """Export the trace, log device busy time (the union of its device
    intervals), the idle share of the wall, the device time of each class
    of operation and of the ``top`` kernel names. False when the trace
    holds no device operation."""
    prof.export_chrome_trace(trace_path)
    ivs = device_intervals(trace_path)
    if not ivs:
        log(f"[{tag}] no device operation in the trace  [{card}]")
        return False
    busy = union_us(ivs)
    span = max(e for _, _, e in ivs) - min(s for _, s, _ in ivs)
    log(f"[{tag}] wall {wall_us / 1e6:.4f} s (profiled), device busy "
        f"{busy / 1e6:.4f} s (union of {len(ivs)} device ops), idle share "
        f"{1 - busy / wall_us:.4f} of the wall, {1 - busy / span:.4f} of the "
        f"{span / 1e6:.4f} s from the first to the last device op  [{card}]")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    by_class = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e in ivs:
        for table, key in ((by_name, name), (by_class, kernel_class(name))):
            table[key][0] += e - s
            table[key][1] += 1
    total = sum(v[0] for v in by_name.values())
    for table, limit in ((by_class, None), (by_name, top)):
        for key, (us, count) in sorted(table.items(),
                                       key=lambda kv: -kv[1][0])[:limit]:
            log(f"[{tag}] {us / 1e3:10.3f} ms {100 * us / total:5.1f}% "
                f"x{count:5d}  {key[:110]}")
    return True


def profile_apply_r(G, R, RF, log, card: str, out_dir: str) -> bool:
    """The ``[apply_r]`` lines: cold and warm stage seconds of the CLI, then
    a traced warm call."""
    from torch.profiler import ProfilerActivity, profile
    from ganreverser_tpu_torch.cli import apply_r
    with tempfile.TemporaryDirectory(prefix="profile_port_") as tmp:
        save = os.path.join(tmp, "logs")
        argv = ["--G", cs.save_models(G, R, RF, save), "--save", save,
                "--writeto", os.path.join(tmp, "out"), "--N", str(cs.N_MAIN),
                "--needles", str(cs.NEEDLES), "--batchSize", "256",
                "--compute_dtype", "bfloat16"]
        for rep in ("cold", "warm"):
            t0 = time.perf_counter()
            seconds = apply_r.main(argv)["seconds"]
            wall = time.perf_counter() - t0
            log(f"[apply_r] {rep}: whole call {wall:.4f} s; stages "
                + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items())
                + f"  [{card}]")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            apply_r.main(argv)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    return summarise_trace(prof, os.path.join(out_dir, "trace_apply_r.json"),
                           wall_us, "apply_r", log, card, top=12)


def profile_train(dev, log, card: str, out_dir: str,
                  n_steps: int = 10) -> bool:
    """The ``[train]`` lines: R's bf16 train step at batch 256 with each
    dropout impl, warm, ``n_steps`` of it traced."""
    from torch.profiler import ProfilerActivity, profile
    from ganreverser_tpu_torch.models import modules, zoo
    from ganreverser_tpu_torch.optim import adam
    from ganreverser_tpu_torch.train.r_loop import make_r_train_step
    from ganreverser_tpu_torch.train.state import TrainState
    bf = torch.bfloat16
    G = zoo.create_G3(cs.DIMS, cs.NOISE_DIM, bf).to(dev)
    G.load_state_dict(cs.make_calibrated_g(dev, n_batches=10).state_dict())
    step = make_r_train_step(G, dtype=bf)
    z = noise_inputs(seeded_generator(3, dev), cs.TRAIN_BATCH, cs.NOISE_DIM,
                     "normal", device=dev)
    for impl in ("kernel", "plain"):
        R = modules.init_parameters(
            zoo.create_R(cs.DIMS, cs.NOISE_DIM, "normal", dtype=bf,
                         dropout_impl=impl),
            torch.Generator().manual_seed(1)).to(dev)
        modules.set_dropout_generator(
            R, torch.Generator(device=dev).manual_seed(2))
        ts = TrainState.create(R, adam())
        for _ in range(3):
            step(ts, z)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                step(ts, z)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        log(f"[train {impl}] b{cs.TRAIN_BATCH} bf16: "
            f"{wall_us / 1e3 / n_steps:.3f} ms/step over {n_steps} traced "
            f"steps  [{card}]")
        if not summarise_trace(prof, os.path.join(out_dir,
                                                  f"trace_train_{impl}.json"),
                               wall_us, f"train {impl}", log, card, top=15):
            return False
    return True


def profile_gan(dev, log, card: str, out_dir: str, n_pairs: int = 10) -> bool:
    """The ``[gan]`` lines: ``n_pairs`` warm batch pairs (D step + G step)
    at batch 256, bf16, adam, traced."""
    from torch.profiler import ProfilerActivity, profile
    from ganreverser_tpu_torch.optim import adam
    from ganreverser_tpu_torch.train.adversarial import (
        Confusion, make_adversarial_steps)
    bf = torch.bfloat16
    gs = cs.make_gan(dev, bf, adam())
    d_step, g_step = make_adversarial_steps(dtype=bf)
    confusion = Confusion.zero(dev)
    batches = cs._gan_batches(dev, cs.TRAIN_BATCH, 4)

    def pair(i):
        real, zd, zg = batches[i % len(batches)]
        d_step(gs, real, zd, confusion)
        g_step(gs, zg)

    for i in range(3):
        pair(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_pairs):
            pair(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    log(f"[gan] b{cs.TRAIN_BATCH} bf16 adam: {wall_us / 1e3 / n_pairs:.3f} "
        f"ms/pair (D step + G step) over {n_pairs} traced pairs  [{card}]")
    return summarise_trace(prof, os.path.join(out_dir, "trace_gan.json"),
                           wall_us, "gan", log, card, top=20)


def profile_distill(dev, log, card: str, out_dir: str,
                    n_batches: int = 20) -> bool:
    """The ``[distill]`` lines: pretrain_prev's batches, warm, traced."""
    from torch.profiler import ProfilerActivity, profile
    from ganreverser_tpu_torch.cli import common, pretrain_prev
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.optim import adam
    c, h, w = cs.DIMS
    with tempfile.TemporaryDirectory(prefix="profile_port_") as tmp:
        prev = ckpt.adversarial_name(os.path.join(tmp, "gan"))
        ckpt.save_checkpoint(prev, common.gan_to_tree(
            cs.make_gan(dev, torch.float32, adam())), config={
                "noiseDim": cs.NOISE_DIM, "noiseMethod": "normal",
                "colorSpace": "rgb", "height": h, "width": w})

        def run(batches):
            return pretrain_prev.main([
                "--network", prev, "--dataset", "synthetic", "--save",
                os.path.join(tmp, "distill"), "--batchSize",
                str(cs.DISTILL_BATCH), "--N_batches", str(batches),
                "--colorSpace", "yuv", "--height", str(h), "--width", str(w),
                "--noiseDim", str(cs.NOISE_DIM), "--compute_dtype",
                "bfloat16"])

        run(10)
        walls = {}
        for batches in (n_batches, 3 * n_batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(batches)
            torch.cuda.synchronize()
            walls[batches] = time.perf_counter() - t0
        marginal = ((walls[3 * n_batches] - walls[n_batches])
                    / (2 * n_batches) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(n_batches)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    log(f"[distill] pretrain_prev b{cs.DISTILL_BATCH} bf16 rgb -> yuv "
        f"{h}x{w}: whole runs of {n_batches} and {3 * n_batches} batches "
        f"{walls[n_batches]:.3f} and {walls[3 * n_batches]:.3f} s, so "
        f"{marginal:.3f} ms per batch beyond the fixed costs (set-up, the "
        f"final checkpoint); traced run of {n_batches}: "
        f"{wall_us / 1e3 / n_batches:.3f} ms/batch  [{card}]")
    return summarise_trace(prof, os.path.join(out_dir, "trace_distill.json"),
                           wall_us, "distill", log, card, top=15)


def profile_apply_r_sections(dev, log, card: str, out_dir: str) -> bool:
    """The ``[e2e]``, ``[layer]``, ``[trace]``, ``[apply_r]`` and
    ``[native]`` lines."""
    G, R, RF = cs.make_models(dev)
    gv = bridge.to_torch(bridge.export_variables(G), dev)
    rv = bridge.to_torch(bridge.export_variables(R), dev)
    dims, nd, n, batch = cs.DIMS, cs.NOISE_DIM, cs.N_MAIN, 256
    bf = torch.bfloat16
    gen_fn = fastpath.make_fast_generator(dims, nd, bf)
    inv_fn = fastpath.make_fast_inverter(dims, nd, "normal", bf)
    needles = torch.tensor([(i + 1) * 100 - 1 for i in range(cs.NEEDLES)],
                           device=dev)

    def e2e():
        _, images, attrs = generate_and_invert(
            gv, rv, dims=dims, n=n, noise_dim=nd, noise_method="normal",
            generator=seeded_generator(1, dev), batch_size=batch, dtype=bf)
        with torch.inference_mode():
            cosine_topk(attrs, needles, 100)
            pixel_cosine_topk(images, needles, 100)

    e2e()
    torch.cuda.synchronize()
    for rep in range(3):
        t0 = time.perf_counter()
        e2e()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[e2e] rep {rep}: generate+invert+search N={n} bf16 {dt:.4f} s"
            f" = {n / dt:.1f} img/s  [{card}]")

    z = noise_inputs(seeded_generator(2, dev), n, nd, "normal", device=dev)
    with torch.inference_mode():
        images = forward_batched(lambda b: gen_fn(gv, b), z, batch)
        for name, fn in (
                ("G-generate",
                 lambda: forward_batched(lambda b: gen_fn(gv, b), z, batch)),
                ("R-invert",
                 lambda: forward_batched(lambda b: inv_fn(rv, b), images,
                                         batch))):
            fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            med = sorted(ts)[1]
            log(f"[layer] {name} N={n} bf16: median {med:.4f} s = "
                f"{n / med:.1f} img/s (3 runs {ts})  [{card}]")
        attrs = forward_batched(lambda b: inv_fn(rv, b), images, batch)
        for name, fn in (
                ("search attributes",
                 lambda: cosine_topk(attrs, needles, 100)),
                ("search pixels",
                 lambda: pixel_cosine_topk(images, needles, 100))):
            log(f"[layer] {name} (warm, incl. topk): "
                f"{cs.time_ms(fn):.4f} ms  [{card}]")
    del images, attrs

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e2e()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if not summarise_trace(prof, os.path.join(out_dir,
                                              "trace_main_path.json"),
                           wall_us, "trace", log, card):
        return False
    if not profile_apply_r(G, R, RF, log, card, out_dir):
        return False

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)

    def native_chain(x, ws):
        y = x.permute(0, 3, 1, 2)
        for w in ws:
            y = F.elu(F.conv2d(y, w, padding=1))
        return F.max_pool2d(y, 2)

    for label, shape, chans in (
            ("R block 1", (256, 64, 64, 3), [3, 64, 64, 64]),
            ("R block 2", (256, 32, 32, 64), [64, 128, 128, 128])):
        x = torch.rand(shape, device=dev, generator=g).to(bf)
        ws = [torch.randn(co, ci, 3, 3, device=dev, generator=g).to(bf)
              for ci, co in zip(chans[:-1], chans[1:])]
        log(f"[native] cuDNN bf16 {label} conv+elu x3 + pool: "
            f"{cs.time_ms(lambda: native_chain(x, ws)):.4f} ms  [{card}]")
    for label, shape, co in (("G stage 1", (256, 16, 16, 512), 256),
                             ("G stage 2", (256, 32, 32, 256), 128)):
        x = torch.rand(shape, device=dev, generator=g).to(bf)
        w = torch.randn(co, shape[-1], 3, 3, device=dev, generator=g).to(bf)

        def up():
            y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                              mode="nearest")
            return F.relu(F.conv2d(y, w, padding=1))
        log(f"[native] cuDNN bf16 {label} upsample+conv+relu (naive): "
            f"{cs.time_ms(up):.4f} ms  [{card}]")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile",
                    help="directory for profile.txt and the trace")
    ap.add_argument("--what", choices=("all", "apply_r", "train", "gan",
                                       "distill"),
                    default="all", help="the sections to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    out = open(os.path.join(args.out, "profile.txt"), "w")

    def log(line: str):
        print(line)
        out.write(line + "\n")

    log(card)
    sections = (("apply_r", profile_apply_r_sections),
                ("train", profile_train), ("gan", profile_gan),
                ("distill", profile_distill))
    for what, section in sections:
        if args.what in ("all", what) and not section(dev, log, card,
                                                      args.out):
            return 1
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
