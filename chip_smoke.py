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
   reference): max error against the stated tolerance, median times.
   Kernel K (one kmeans step, f32) at (10,000, 100), K = 20, and at a
   ragged N with an empty cluster, on the same given centroids: the
   assignment must agree wherever the plain margin exceeds 1e-4 of max |d|,
   the counts be those of the kernel's assignment and the sums the plain
   sums over it (1e-4 relative), and a second run be bitwise the same;
4. the main path at full width: random G3, R and fixer-R (3x64x64, noise
   dim 100, normal noise, non-trivial BN running statistics) saved as
   checkpoints, then ``cli.apply_r.main`` with N = 10,000, 10 needles, batch
   256, bf16 and all six stages. Every kernel must have launched in that
   run (K at least once per Lloyd iteration); every artifact must exist,
   the latents be finite, the cluster counts sum to N, the anomaly count be
   the one the threshold implies and the top-k scores agree with the plain
   search. Then, on the card in f32, the fast path and the fast fixer-R
   against the plain module path (same z, same dropout mask) on 512 rows,
   and latent refinement of 512 of the images: no image's loss may rise,
   and the chunked refiner must match one chunk on 256 rows.

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
TOL_SUMS = 1e-4        # kmeans sums vs plain, relative to max(1, max |sum|)
KMEANS_K, KMEANS_ITERS = 20, 15   # apply_r.lua:158
REFINE_STEPS = 5


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


def kmeans_case(x, c):
    """Kernel K against its plain version on the same centroids. Returns
    (max |kernel sums - plain sums over the kernel's assignment|, its
    tolerance, rows whose assignment differs from the plain one)."""
    import torch
    from ganreverser_tpu_torch.ops import kmeans_kernel as kk
    new_c, counts, sums, assign = kk.kmeans_step(x, c, details=True)
    torch.cuda.synchronize()
    again = kk.kmeans_step(x, c, details=True)
    check(all(torch.equal(a, b) for a, b in zip((new_c, counts, sums, assign),
                                                again)),
          "kmeans_step: two runs differ")
    _, _, _, ref_assign = kk.kmeans_step_plain(x, c, details=True)
    d = (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)
    top2 = torch.topk(d, 2, dim=1, largest=False).values
    sure = (top2[:, 1] - top2[:, 0]) > 1e-4 * d.abs().max()
    flipped = int((assign != ref_assign).sum())
    check(torch.equal(assign[sure], ref_assign[sure]),
          "kmeans_step: assignment differs from plain beyond the margin")
    k = c.shape[0]
    check(torch.equal(counts, torch.bincount(assign, minlength=k).float()),
          "kmeans_step: counts are not those of its assignment")
    ref_sums = torch.nn.functional.one_hot(assign, k).float().T @ x
    err = (sums - ref_sums).abs().max().item()
    tol = TOL_SUMS * max(1.0, ref_sums.abs().max().item())
    check(err <= tol, f"kmeans_step: sums differ from plain by {err} > {tol}")
    ref_new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp_min(counts, 1.0)[:, None], c)
    check(torch.equal(new_c, ref_new),
          "kmeans_step: centroids are not sums / counts")
    return err, tol, flipped


def check_kmeans(dev, card: str, n: int = N_MAIN):
    """Phase 3, kernel K: a Lloyd step at the main path's shape, and at a
    ragged N with an empty cluster; returns one record."""
    import torch
    from ganreverser_tpu_torch.ops import kmeans_kernel as kk
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn(n, NOISE_DIM, device=dev, generator=gen)
    c = x[torch.randperm(n, device=dev, generator=gen)[:KMEANS_K]]
    err, tol, flipped = kmeans_case(x, c)
    ms = time_ms(lambda: kk.kmeans_step(x, c))
    plain_ms = time_ms(lambda: kk.kmeans_step_plain(x, c))
    print(f"[kernel] kmeans_step ({n},{NOISE_DIM}) K={KMEANS_K} float32: "
          f"sums max_abs_err {err:.3e} (tol {tol:.1e}), "
          f"{flipped} near-tie rows assigned otherwise, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms per Lloyd step  [{card}]")
    xr = x[:777]
    cr = c.clone()
    cr[-1] = 0.0
    cr[-1, 0] = 50.0  # no row comes near: an empty cluster
    err_r, tol_r, flipped_r = kmeans_case(xr, cr)
    counts = kk.kmeans_step(xr, cr)[1]
    check(counts[-1].item() == 0.0, "kmeans_step: the far cluster is not "
          "empty")
    print(f"[kernel] kmeans_step ragged (777,{NOISE_DIM}) K={KMEANS_K} with "
          f"an empty cluster: sums max_abs_err {err_r:.3e} (tol {tol_r:.1e}), "
          f"{flipped_r} "
          f"near-tie rows  [{card}]")
    return {"name": "kmeans_step", "label": f"({n},{NOISE_DIM}) K={KMEANS_K}",
            "dtype": "float32", "max_abs_err": max(err, err_r), "ms": ms,
            "plain_ms": plain_ms}


def make_models(dev, dims=DIMS, noise_dim=NOISE_DIM):
    """Phase 4a: G3, R and the fixer-R with seeded random weights and
    non-trivial BN running statistics."""
    import torch
    from ganreverser_tpu_torch.models import modules, zoo
    gen = torch.Generator().manual_seed(SEED)
    models = []
    for model in (zoo.create_G3(dims, noise_dim),
                  zoo.create_R(dims, noise_dim, "normal"),
                  zoo.create_R(dims, noise_dim, "normal", fixer=True)):
        modules.init_parameters(model, gen)
        for m in model.modules():
            if isinstance(m, modules.BatchNorm):
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, generator=gen))
                m.var.copy_(0.5 + torch.rand(m.var.shape, generator=gen))
        models.append(model.to(dev))
    return models


def save_models(G, R, RF, save: str, dims=DIMS,
                noise_dim=NOISE_DIM) -> str:
    """Checkpoints laid out as apply_r expects; returns G's path."""
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.models.bridge import export_variables
    c, h, w = dims
    cfg = {"noiseDim": noise_dim, "noiseMethod": "normal",
           "colorSpace": "rgb", "height": h, "width": w}
    g_path = ckpt.adversarial_name(save)
    ckpt.save_checkpoint(g_path, {"G": export_variables(G)}, config=cfg)
    for model, fixer in ((R, False), (RF, True)):
        ckpt.save_checkpoint(ckpt.r_name(save, c, h, w, noise_dim, "normal",
                                         fixer),
                             {"R": export_variables(model)}, config=cfg)
    return g_path


def kernel_counters():
    from ganreverser_tpu_torch.ops import (conv_block_kernel,
                                           kmeans_kernel, topk_kernel,
                                           upsample_conv_kernel)
    return {"conv_block": conv_block_kernel.conv_block,
            "upsample2_conv3x3_bn_act":
                upsample_conv_kernel.upsample2_conv3x3_bn_act,
            "cosine_scores": topk_kernel.cosine_scores,
            "kmeans_step": kmeans_kernel.kmeans_step}


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
    """Phase 4c: every artifact, finite latents, cluster counts summing to
    N, the anomaly count the threshold implies, search scores vs plain.
    Returns the two top-k score errors."""
    import torch
    from ganreverser_tpu_torch.ops.topk_kernel import cosine_scores_plain
    names = ["variations.jpg", "fixed_pairs.jpg", "fixed_images_528.jpg",
             "fixed_images_528_unfixed.jpg", "anomalies.jpg",
             "apply_r_stats.jsonl"]
    names += [f"similar_{tag}_{i:02d}.jpg" for i in range(1, needles + 1)
              for tag in ("attributes", "pixelwise")]
    with open(os.path.join(out_dir, "apply_r_stats.jsonl")) as f:
        stats = [json.loads(line) for line in f]
    sizes = [r["value"] for r in stats if r["tag"] == "cluster_size"]
    names += [f"cluster_{ci + 1:02d}.jpg" for ci, size in enumerate(sizes)
              if size > 0]
    for name in names:
        check(os.path.isfile(os.path.join(out_dir, name)), f"missing {name}")
    check(len(sizes) == KMEANS_K and sum(sizes) == n,
          f"cluster sizes {sizes} do not sum to {n}")
    check(result["counts"].sum().item() == n,
          f"kmeans counts sum to {result['counts'].sum().item()}, not {n}")
    scores, thr = result["scores"], result["threshold"]
    implied = int((scores <= thr).sum())
    n_calc = scores.shape[0]
    flagged = int(result["is_anomaly"].sum())
    count = [r["value"] for r in stats if r["tag"] == "anomaly_count"]
    check(flagged == implied == count[0] and implied >= int(n_calc * 0.15),
          f"anomalies: {flagged} flagged, {implied} implied by the "
          f"threshold, {count} in the stats")
    attrs, images = result["attributes"], result["images"]
    for name in ("attributes", "attributes_fixer"):
        check(tuple(result[name].shape) == (n, noise_dim),
              f"{name} shape {tuple(result[name].shape)}")
        check(bool(torch.isfinite(result[name]).all()), f"non-finite {name}")
    for name in ("images", "fixed", "variations"):
        check(bool(torch.isfinite(result[name]).all()), f"non-finite {name}")
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


def _path_err(what: str, a, b) -> float:
    err = (a - b).abs().max().item()
    scale = max(1.0, b.abs().max().item())
    check(err <= TOL_PATH * scale,
          f"fast vs plain {what}: {err} > {TOL_PATH * scale}")
    return err


def compare_paths(G, R, RF, dev, n: int = N_COMPARE, dims=DIMS,
                  noise_dim=NOISE_DIM):
    """Phase 4d: fast path (kernels) vs the plain module path, f32, on the
    same z, and the fast fixer vs the module fixer-R on the same dropout
    mask. Returns the image, latent and fixer-latent errors."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models import bridge, fastpath
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    z = noise_inputs(gen, n, noise_dim, "normal", device=dev)
    g_vars, r_vars, rf_vars = (
        bridge.to_torch(bridge.export_variables(m), dev) for m in (G, R, RF))
    f32 = torch.float32
    with torch.inference_mode():
        fast_images = fastpath.make_fast_generator(dims, noise_dim, f32)(
            g_vars, z)
        fast_z = fastpath.make_fast_inverter(dims, noise_dim, "normal", f32)(
            r_vars, fast_images)
        fast_zf = fastpath.make_fast_fixer(dims, noise_dim, "normal", f32)(
            rf_vars, fast_images,
            torch.Generator(device=dev).manual_seed(SEED + 5))
        plain_images = G(z)
        plain_z = R(plain_images)
        RF.l0.generator = torch.Generator(device=dev).manual_seed(SEED + 5)
        plain_zf = RF(fast_images)
    return (_path_err("images", fast_images, plain_images),
            _path_err("latents", fast_z, plain_z),
            _path_err("fixer latents", fast_zf, plain_zf))


def check_refine(G, images, z0, n_chunk: int = 256):
    """Phase 4e: adam on z through the module G (f32) for the images and
    first guesses given: no image's loss may rise, and the chunked refiner
    must match one chunk on ``n_chunk`` rows. Returns (loss before, after,
    chunk error, seconds)."""
    import torch
    from ganreverser_tpu_torch.analysis.refine import make_refiner
    f32 = torch.float32
    images, z0 = images.float(), z0.float()
    _, loss0 = make_refiner(G, steps=0, dtype=f32)(images, z0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, loss = make_refiner(G, steps=REFINE_STEPS, dtype=f32,
                           batch_size=256)(images, z0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(bool(torch.isfinite(z).all()), "refine: non-finite latents")
    rose = int((loss > loss0).sum())
    check(rose == 0, f"refine: the loss rose on {rose} of {len(loss)} "
          f"images (max rise {(loss - loss0).max().item():.3e})")
    za, _ = make_refiner(G, steps=REFINE_STEPS, dtype=f32,
                         batch_size=n_chunk // 2)(images[:n_chunk],
                                                  z0[:n_chunk])
    zb, _ = make_refiner(G, steps=REFINE_STEPS, dtype=f32)(images[:n_chunk],
                                                           z0[:n_chunk])
    err = _path_err("refined latents, chunked vs one chunk", za, zb)
    return loss0.mean().item(), loss.mean().item(), err, seconds


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
    records.append(check_kmeans(dev, card))

    # 4. the main path at full width
    G, R, RF = make_models(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        save, out_dir = os.path.join(tmp, "logs"), os.path.join(tmp, "out")
        g_path = save_models(G, R, RF, save)
        result, launches, seconds = run_main_path(g_path, save, out_dir)
        for name, count in launches.items():
            check(count > 0, f"kernel {name} launched no time in the main "
                  "path")
        check(launches["kmeans_step"] >= KMEANS_ITERS,
              f"kmeans_step launched {launches['kmeans_step']} times, fewer "
              f"than the {KMEANS_ITERS} Lloyd iterations")
        score_errs = check_main_path(result, out_dir)
    secs = result["seconds"]
    print(f"[main] apply_r N={N_MAIN} bf16 batch 256, all six stages + "
          f"fixer-R: whole call {seconds:.2f} s; launches {launches}; top-k "
          f"score error vs plain {max(score_errs):.2e}  [{card}]")
    print(f"[main] stage seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in secs.items()) +
        f"; generate+invert {N_MAIN / secs['generate_invert']:.1f} img/s "
        f"(G, R and the fixer-R)  [{card}]")
    loss0, loss1, chunk_err, refine_s = check_refine(
        G, result["images"][:N_COMPARE], result["attributes"][:N_COMPARE])
    print(f"[main] refine {N_COMPARE} images, {REFINE_STEPS} adam steps, f32 "
          f"module G: mean pixel MSE {loss0:.4e} -> {loss1:.4e}, no image "
          f"rose; {refine_s:.3f} s; chunked vs one chunk on 256 rows "
          f"max_abs_err {chunk_err:.3e}  [{card}]")
    del result
    img_err, z_err, zf_err = compare_paths(G, R, RF, dev)
    print(f"[main] fast vs plain module path, f32, {N_COMPARE} rows: images "
          f"max_abs_err {img_err:.3e}, latents {z_err:.3e}, fixer latents "
          f"(same mask) {zf_err:.3e}  [{card}]")

    sources = {"conv_block": ("ganreverser_tpu_torch/csrc/conv_block.cu",
                              "ganreverser_tpu/ops/conv_block_kernel.py:86"),
               "upsample2_conv3x3_bn_act": (
                   "ganreverser_tpu_torch/csrc/upsample_conv.cu",
                   "ganreverser_tpu/ops/upsample_conv_kernel.py:122"),
               "cosine_scores": ("ganreverser_tpu_torch/csrc/cosine_scores.cu",
                                 "ganreverser_tpu/ops/topk_kernel.py:69"),
               "kmeans_step": ("ganreverser_tpu_torch/csrc/kmeans.cu",
                               "ganreverser_tpu/ops/kmeans_kernel.py:97")}
    kernels = []
    for name, (source, replaces) in sources.items():
        # the main path's dtype (bf16; kmeans runs in f32), summed over the
        # path's shapes
        recs = [r for r in records if r["name"] == name and r["dtype"] == (
            "float32" if name == "kmeans_step" else "bfloat16")]
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
