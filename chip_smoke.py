#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ganreverser_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build the CUDA kernels of ganreverser_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card at the shapes
   of the main path (N = 256, f32 and bf16, TF32 off for the plain f32
   reference): max error against the stated tolerance, median times;
4. the main path at full width: random G3 and R (3x64x64, noise dim 100,
   normal noise, non-trivial BN running statistics) saved as checkpoints,
   then ``cli.apply_r.main`` with N = 10,000, 10 needles, batch 256, bf16.
   Every kernel must have launched in that run; the similar_* files must
   exist, the latents be finite and the top-k scores agree with the plain
   search. Then the fast path against the plain module path on the card
   (f32) on 512 rows of the same z.

The last two lines are a JSON object with each kernel's route, source,
launch count in the main path, error and times, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when CUDA is absent or the package is not
beside this file.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
N_CHECK = 256          # rows per kernel check (one chunk of the main path)
N_MAIN = 10_000        # apply_r's N (apply_r.lua:145)
NEEDLES = 10
DIMS, NOISE_DIM = (3, 64, 64), 100
N_COMPARE = 512        # rows of the fast vs plain comparison
# max |kernel - plain| <= TOL * max(1, max |plain|): f32 sums in another
# order; bf16 one rounding per layer at the same places in both versions,
# which may still land on neighbouring bf16 values (1e-2 of the largest
# output is 1.3 to 2.6 bf16 ulps of it)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_SCORES = 1e-4      # cosine scores, inputs cast to f32 in both versions
TOL_PATH = 1e-3        # fast vs plain module path, f32, relative to scale


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call of ``fn``, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _conv_chain(gen, dev, chans):
    import torch
    ks, scs, shs = [], [], []
    for ci, co in zip(chans[:-1], chans[1:]):
        std = 1.0 / math.sqrt(9 * ci)
        ks.append(std * torch.randn(3, 3, ci, co, device=dev, generator=gen))
        scs.append(0.5 + torch.rand(co, device=dev, generator=gen))
        shs.append(0.1 * torch.randn(co, device=dev, generator=gen))
    return ks, scs, shs


def kernel_cases(dev, n: int, n_search: int):
    """(kernel, label, make(dtype) -> (kernel_fn, plain_fn)) at the main
    path's shapes."""
    import torch
    from ganreverser_tpu_torch.ops import (conv_block_kernel as cb,
                                           topk_kernel as tk,
                                           upsample_conv_kernel as uc)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c, h, w = DIMS
    cases = []

    def block(label, shape, chans):
        x0 = torch.rand(shape, device=dev, generator=gen)
        ks, scs, shs = _conv_chain(gen, dev, chans)

        def make(dtype):
            x = x0.to(dtype)
            return (lambda: cb.conv_block(x, ks, scs, shs, act="elu",
                                          pool=True),
                    lambda: cb.conv_block_plain(x, ks, scs, shs, act="elu",
                                                pool=True))
        cases.append(("conv_block", label, make))

    def upsample(label, shape, co):
        x0 = torch.rand(shape, device=dev, generator=gen)
        ci = shape[-1]
        k = torch.randn(3, 3, ci, co, device=dev, generator=gen) / math.sqrt(
            9 * ci)
        sc = 0.5 + torch.rand(co, device=dev, generator=gen)
        sh = 0.1 * torch.randn(co, device=dev, generator=gen)

        def make(dtype):
            x = x0.to(dtype)
            return (lambda: uc.upsample2_conv3x3_bn_act(x, k, sc, sh,
                                                        act="relu"),
                    lambda: uc.upsample2_conv3x3_bn_act_plain(x, k, sc, sh,
                                                              act="relu"))
        cases.append(("upsample2_conv3x3_bn_act", label, make))

    def search(label, d, positive):
        e0 = torch.randn(n_search, d, device=dev, generator=gen)
        if positive:  # pixels are sigmoid outputs in [0, 1]
            e0 = torch.sigmoid(e0)
        idx = torch.tensor([(i + 1) * 100 - 1 for i in range(NEEDLES)],
                           device=dev)

        def make(dtype):
            e = e0.to(dtype)
            return (lambda: tk.cosine_scores(e, idx),
                    lambda: tk.cosine_scores_plain(e, idx))
        cases.append(("cosine_scores", label, make))

    block(f"R block 1 ({n},{h},{w},{c})->64x3+pool", (n, h, w, c),
          [c, 64, 64, 64])
    block(f"R block 2 ({n},{h // 2},{w // 2},64)->128x3+pool",
          (n, h // 2, w // 2, 64), [64, 128, 128, 128])
    upsample(f"G stage 1 ({n},{h // 4},{w // 4},512)->256",
             (n, h // 4, w // 4, 512), 256)
    upsample(f"G stage 2 ({n},{h // 2},{w // 2},256)->128",
             (n, h // 2, w // 2, 256), 128)
    search(f"attributes ({n_search},{NOISE_DIM}) x {NEEDLES}", NOISE_DIM,
           False)
    search(f"pixels ({n_search},{c * h * w}) x {NEEDLES}", c * h * w, True)
    return cases


def check_kernels(dev, card: str, n: int = N_CHECK, n_search: int = N_MAIN):
    """Phase 3: every kernel against its plain version; returns one record
    per (kernel, shape, dtype)."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    records = []
    for name, label, make in kernel_cases(dev, n, n_search):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kern, plain = make(dtype)
            out = kern()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ref = plain()
            check(out.shape == ref.shape and out.dtype == ref.dtype,
                  f"{name} {label} {dname}: {tuple(out.shape)} {out.dtype} "
                  f"vs plain {tuple(ref.shape)} {ref.dtype}")
            check(bool(torch.isfinite(out).all()),
                  f"{name} {label} {dname}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            tol = (TOL_SCORES if name == "cosine_scores"
                   else TOL[dname] * scale)
            del out, ref
            ms, plain_ms = time_ms(kern), time_ms(plain)
            print(f"[kernel] {name} {label} {dname}: max_abs_err {err:.3e} "
                  f"(tol {tol:.1e}), kernel {ms:.4f} ms, plain {plain_ms:.4f}"
                  f" ms  [{card}]")
            check(err <= tol, f"{name} {label} {dname}: max_abs_err {err} "
                  f"> tol {tol}")
            records.append({"name": name, "label": label, "dtype": dname,
                            "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms})
    return records


def make_models(dev, dims=DIMS, noise_dim=NOISE_DIM):
    """Phase 4a: G3 and R with seeded random weights and non-trivial BN
    running statistics."""
    import torch
    from ganreverser_tpu_torch.models import modules, zoo
    gen = torch.Generator().manual_seed(SEED)
    models = []
    for model in (zoo.create_G3(dims, noise_dim),
                  zoo.create_R(dims, noise_dim, "normal")):
        modules.init_parameters(model, gen)
        for m in model.modules():
            if isinstance(m, modules.BatchNorm):
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, generator=gen))
                m.var.copy_(0.5 + torch.rand(m.var.shape, generator=gen))
        models.append(model.to(dev))
    return models


def save_models(G, R, save: str, dims=DIMS, noise_dim=NOISE_DIM) -> str:
    """Checkpoints laid out as apply_r expects; returns G's path."""
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.models.bridge import export_variables
    c, h, w = dims
    cfg = {"noiseDim": noise_dim, "noiseMethod": "normal",
           "colorSpace": "rgb", "height": h, "width": w}
    g_path = ckpt.adversarial_name(save)
    ckpt.save_checkpoint(g_path, {"G": export_variables(G)}, config=cfg)
    ckpt.save_checkpoint(ckpt.r_name(save, c, h, w, noise_dim, "normal",
                                     False),
                         {"R": export_variables(R)}, config=cfg)
    return g_path


def kernel_counters():
    from ganreverser_tpu_torch.ops import (conv_block_kernel,
                                           topk_kernel,
                                           upsample_conv_kernel)
    return {"conv_block": conv_block_kernel.conv_block,
            "upsample2_conv3x3_bn_act":
                upsample_conv_kernel.upsample2_conv3x3_bn_act,
            "cosine_scores": topk_kernel.cosine_scores}


def run_main_path(g_path: str, save: str, out_dir: str, n: int = N_MAIN,
                  needles: int = NEEDLES, batch: int = 256,
                  dtype: str = "bfloat16"):
    """Phase 4b: apply_r through its entry point, counting kernel launches
    in that run only. Returns (result, launches, seconds)."""
    from ganreverser_tpu_torch.cli import apply_r
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = apply_r.main(["--G", g_path, "--save", save, "--writeto",
                           out_dir, "--N", str(n), "--needles", str(needles),
                           "--batchSize", str(batch), "--compute_dtype",
                           dtype])
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    return result, launches, seconds


def check_main_path(result, out_dir: str, n: int = N_MAIN,
                    needles: int = NEEDLES, noise_dim: int = NOISE_DIM):
    """Phase 4c: artifacts, finite latents, search scores vs plain."""
    import torch
    from ganreverser_tpu_torch.ops.topk_kernel import cosine_scores_plain
    for i in range(1, needles + 1):
        for tag in ("attributes", "pixelwise"):
            f = os.path.join(out_dir, f"similar_{tag}_{i:02d}.jpg")
            check(os.path.isfile(f), f"missing {f}")
    attrs, images = result["attributes"], result["images"]
    check(tuple(attrs.shape) == (n, noise_dim),
          f"attributes shape {tuple(attrs.shape)}")
    check(bool(torch.isfinite(attrs).all()), "non-finite attributes")
    check(bool(torch.isfinite(images).all()), "non-finite images")
    idx = torch.tensor([(i + 1) * 100 - 1 for i in range(needles)],
                       device=attrs.device)
    errs = []
    for emb, (scores, _) in ((attrs, result["attr_topk"]),
                             (images.reshape(n, -1), result["pix_topk"])):
        ref = torch.topk(cosine_scores_plain(emb, idx), scores.shape[1],
                         dim=1).values
        errs.append((scores - ref).abs().max().item())
    check(max(errs) <= TOL_SCORES,
          f"top-k scores differ from the plain search by {max(errs)}")
    return errs


def compare_paths(G, R, dev, n: int = N_COMPARE, dims=DIMS,
                  noise_dim=NOISE_DIM):
    """Phase 4d: fast path (kernels) vs the plain module path, f32, on the
    same z. Returns (image error, latent error)."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models import bridge, fastpath
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    z = noise_inputs(gen, n, noise_dim, "normal", device=dev)
    g_vars = bridge.to_torch(bridge.export_variables(G), dev)
    r_vars = bridge.to_torch(bridge.export_variables(R), dev)
    with torch.inference_mode():
        fast_images = fastpath.make_fast_generator(dims, noise_dim,
                                                   torch.float32)(g_vars, z)
        fast_z = fastpath.make_fast_inverter(dims, noise_dim, "normal",
                                             torch.float32)(r_vars,
                                                            fast_images)
        plain_images = G(z)
        plain_z = R(plain_images)
    errs = []
    for what, a, b in (("images", fast_images, plain_images),
                       ("latents", fast_z, plain_z)):
        err = (a - b).abs().max().item()
        scale = max(1.0, b.abs().max().item())
        check(err <= TOL_PATH * scale,
              f"fast vs plain {what}: {err} > {TOL_PATH * scale}")
        errs.append(err)
    return errs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    try:
        from ganreverser_tpu_torch.ops import cuda_lib
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.environ["GANREVERSER_PLATFORM"] = "gpu"

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"[card] torch: {kind}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.parent / f"build_{cuda_lib.source_hash()}.log"
    if log.is_file():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    # 3. kernels against their plain versions
    records = check_kernels(dev, card)

    # 4. the main path at full width
    G, R = make_models(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        save, out_dir = os.path.join(tmp, "logs"), os.path.join(tmp, "out")
        g_path = save_models(G, R, save)
        result, launches, seconds = run_main_path(g_path, save, out_dir)
        for name, count in launches.items():
            check(count > 0, f"kernel {name} launched no time in the main "
                  "path")
        score_errs = check_main_path(result, out_dir)
    gen_inv_s = result["seconds"]["generate_invert"]
    search_s = result["seconds"]["search"]
    print(f"[main] apply_r N={N_MAIN} bf16 batch 256: generate+invert "
          f"{gen_inv_s:.3f} s = {N_MAIN / gen_inv_s:.1f} img/s, search "
          f"{search_s * 1e3:.3f} ms, whole call {seconds:.2f} s; launches "
          f"{launches}; top-k score error vs plain {max(score_errs):.2e}  "
          f"[{card}]")
    del result
    img_err, z_err = compare_paths(G, R, dev)
    print(f"[main] fast vs plain module path, f32, {N_COMPARE} rows: images "
          f"max_abs_err {img_err:.3e}, latents {z_err:.3e}  [{card}]")

    sources = {"conv_block": ("ganreverser_tpu_torch/csrc/conv_block.cu",
                              "ganreverser_tpu/ops/conv_block_kernel.py:86"),
               "upsample2_conv3x3_bn_act": (
                   "ganreverser_tpu_torch/csrc/upsample_conv.cu",
                   "ganreverser_tpu/ops/upsample_conv_kernel.py:122"),
               "cosine_scores": ("ganreverser_tpu_torch/csrc/cosine_scores.cu",
                                 "ganreverser_tpu/ops/topk_kernel.py:69")}
    kernels = []
    for name, (source, replaces) in sources.items():
        # bf16, the main path's dtype: summed over the path's shapes
        recs = [r for r in records
                if r["name"] == name and r["dtype"] == "bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": sum(r["ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs)})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
