"""Inversion/analysis suite CLI — apply_r.lua, the counterpart of
ganreverser_tpu/cli/apply_r.py, with its six stages in its order and its
artifact names:

  ① variations.jpg                  latent-component sweep (fast G)
  ② generate N faces with G and recover their latents with R and, when a
    fixer checkpoint exists, the fixer-R (fast G, fast R on kernel B;
    --int8: G and R on the int8 kernels Q1-Q4, the fixer-R on kernel B)
    [--refine_steps > 0: adam on the latents through the module G]
  ③ cluster_NN.jpg                  kmeans on kernel K, min-cosine members
                                    (the average first, then the top 71)
  ④ similar_attributes_NN.jpg       cosine top-k on kernel C, over the
    similar_pixelwise_NN.jpg        recovered latents and over raw pixels
                                    (--approx: selected by kernel S at
                                    --recall_target)
  ⑤ fixed_pairs.jpg, fixed_images_528[_unfixed].jpg   G on the (fixer)
                                    latents
  ⑥ anomalies.jpg                   1 - L2 scores, 15 % quantile threshold
  apply_r_stats.jsonl               n_inverted, the threshold, the anomaly
                                    count and each cluster's size

It reads the checkpoints the JAX package writes (io/checkpoint.py). On CUDA
(GANREVERSER_PLATFORM unset or gpu) the kernels run; with
GANREVERSER_PLATFORM=cpu their plain versions run. Each stage draws its
random numbers from a generator of its own (core/prng.py). --mesh_* > 1
is refused.

Usage: python -m ganreverser_tpu_torch.cli.apply_r --G logs/adversarial \
           --N 10000 --compute_dtype bfloat16
"""
from __future__ import annotations

import math
import os
import sys
import time

import numpy as np
import torch

from ..analysis.kmeans import assign_min_cosine, cluster_members, kmeans
from ..analysis.pipeline import (detect_anomalies, fix_images,
                                 generate_and_invert, variation_sweep)
from ..analysis.refine import make_refiner
from ..analysis.similarity import cosine_topk, pixel_cosine_topk
from ..core.config import ApplyConfig
from ..core.prng import stage_generator
from ..data.colorspace import to_rgb
from ..io import checkpoint as ckpt
from ..io.metrics import MetricsWriter
from ..models import zoo
from ..models.bridge import load_jax_variables, to_torch
from ..utils.grids import BLUE, RED, add_border, images_to_grid, save_image
from . import common

NB_STEPS = 16              # variation steps per component (apply_r.lua:117)
MEMBERS = 64 + 7           # images per cluster grid (apply_r.lua:222-230)
NB_PAIRS, NB_FIXED = 52, 512 + 16  # apply_r.lua:324-352


def _square_grid(images_rgb: np.ndarray):
    n = images_rgb.shape[0]
    side = math.ceil(math.sqrt(n))
    return images_to_grid(images_rgb, math.ceil(n / side), side)


def _side_grid(images_rgb: np.ndarray):
    n = images_rgb.shape[0]
    side = int(math.sqrt(n))
    return images_to_grid(images_rgb, math.ceil(n / side), side)


def _refuse_unported(cfg: ApplyConfig):
    refused = [flag for flag, on in (
        ("--mesh_data > 1 (ROADMAP.md, queue A item 8)", cfg.mesh_data > 1),
        ("--mesh_model > 1 (queue A item 8)", cfg.mesh_model > 1)) if on]
    if refused:
        sys.exit(f"[apply_r] not ported yet: {', '.join(refused)}")


class _StageClock:
    """Seconds of each stage, synchronised with the device at both ends."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, title: str):
        print(f"[apply_r] {title}")
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self, name: str, detail: str = "") -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self.seconds[name] = dt
        print(f"[apply_r]   {name}: {dt:.3f} s{detail}")
        return dt


def _load_variables(path: str, key: str, device: torch.device) -> dict:
    tree, _, _ = ckpt.load_checkpoint(path)
    return to_torch({"params": tree[key]["params"],
                     "state": tree[key]["state"]}, device)


def main(argv=None) -> dict:
    """Run the six stages; returns the recovered latents (plain and fixer),
    the images, the variations, the kmeans centroids, counts and
    assignment, both top-k results, the fixed images, the anomaly scores,
    threshold and flags, the stage times in seconds and the device."""
    cfg = ApplyConfig.from_args(argv, "inversion/analysis suite (apply_r.lua)")
    _refuse_unported(cfg)
    device = common.resolve_device()
    dtype = common.compute_dtype(cfg)
    if cfg.N < cfg.needles * 100:
        sys.exit(f"--needles {cfg.needles} requires --N >= "
                 f"{cfg.needles * 100} (needle indices are (i+1)*100-1, "
                 "apply_r.lua:272)")
    if cfg.approx and not 0 < cfg.recall_target <= 1:
        sys.exit(f"--recall_target {cfg.recall_target} must lie in (0, 1]")
    if not 0 < cfg.clusters <= cfg.N:
        sys.exit(f"--clusters {cfg.clusters} must lie in 1..N ({cfg.N})")
    os.makedirs(cfg.writeto, exist_ok=True)
    batch = max(cfg.batchSize, 256)

    # --- load G (inherit geometry) + R + R_fixer (apply_r.lua:59-109) ---
    g_tree, g_cfg, _ = ckpt.load_checkpoint(cfg.G)
    noise_dim = g_cfg["noiseDim"]
    noise_method = g_cfg["noiseMethod"]
    colorspace = g_cfg["colorSpace"]
    h, w = g_cfg["height"], g_cfg["width"]
    c = 1 if colorspace == "y" else 3
    dims = (c, h, w)
    g_vars = to_torch({"params": g_tree["G"]["params"],
                       "state": g_tree["G"]["state"]}, device)
    r_path = cfg.R or ckpt.r_name(cfg.save, c, h, w, noise_dim, noise_method,
                                  False)
    rf_path = cfg.R_fixer or ckpt.r_name(cfg.save, c, h, w, noise_dim,
                                         noise_method, True)
    r_vars = _load_variables(r_path, "R", device)
    rf_vars = None
    if ckpt.exists(rf_path):
        rf_vars = _load_variables(rf_path, "R", device)
    else:
        print(f"[apply_r] no fixer checkpoint at {rf_path}; using plain R "
              "for fixing/anomalies")
    print(f"[apply_r] G {cfg.G}, R {r_path}, fixer "
          f"{rf_path if rf_vars is not None else '-'}: {c}x{h}x{w}, noise "
          f"{noise_method}/{noise_dim}, {cfg.compute_dtype} on {device}")
    clock = _StageClock(device)

    def rgb(x: torch.Tensor) -> np.ndarray:
        return to_rgb(x.float().cpu().numpy(), colorspace)

    # --- ① variation sweep (apply_r.lua:115-138) ---
    clock.start("stage ① variation sweep")
    variations = variation_sweep(
        g_vars, dims=dims, noise_dim=noise_dim, noise_method=noise_method,
        generator=stage_generator(cfg.seed, 1, device), nb_steps=NB_STEPS,
        batch_size=batch, dtype=dtype)
    clock.stop("variations")
    save_image(os.path.join(cfg.writeto, "variations.jpg"),
               images_to_grid(rgb(variations), noise_dim, NB_STEPS))

    # --- ② generate N + invert (apply_r.lua:143-153) ---
    clock.start("stage ② generate + invert")
    out = generate_and_invert(
        g_vars, r_vars, dims=dims, n=cfg.N, noise_dim=noise_dim,
        noise_method=noise_method,
        generator=stage_generator(cfg.seed, 2, device), batch_size=batch,
        dtype=dtype, rf_variables=rf_vars,
        fixer_generator=stage_generator(cfg.seed, 5, device), int8=cfg.int8)
    _, images, attributes = out[:3]
    attributes_fixer = out[3] if rf_vars is not None else attributes
    t = clock.stop("generate_invert")
    print(f"[apply_r]   {cfg.N} images ({cfg.N / t:.1f} img/s)"
          f"{', int8 G and R' if cfg.int8 else ''}"
          f"{', fixer-R included' if rf_vars is not None else ''}")

    # --- optional: gradient-based latent refinement ---
    if cfg.refine_steps > 0:
        clock.start(f"refining latents ({cfg.refine_steps} adam steps on z)")
        G = load_jax_variables(zoo.create_G3(dims, noise_dim, dtype),
                               g_tree["G"]).to(device)
        refine = make_refiner(G, steps=cfg.refine_steps, lr=cfg.refine_lr,
                              dtype=dtype, batch_size=batch)
        attributes, final_loss = refine(images, attributes)
        if rf_vars is None:
            # no fixer-R: fixing and anomalies follow the refined latents
            attributes_fixer = attributes
        clock.stop("refine",
                   f", final pixel MSE {final_loss.mean().item():.6f}")

    # --- ③ clustering (apply_r.lua:158-163, 197-260) ---
    clock.start("stage ③ clustering")
    centroids, counts = kmeans(attributes, cfg.clusters, cfg.kmeans_iters,
                               generator=stage_generator(cfg.seed, 3, device))
    assign, sims = assign_min_cosine(attributes, centroids)
    assign_host, sims_host = assign.cpu().numpy(), sims.cpu().numpy()
    clock.stop("cluster")
    images_host = rgb(images)  # the one host copy of the N images
    for ci in range(cfg.clusters):
        members = cluster_members(assign_host, sims_host, ci, MEMBERS)
        if len(members) == 0:
            continue
        cluster_imgs = images_host[members]
        tile = np.concatenate([cluster_imgs.mean(axis=0, keepdims=True),
                               cluster_imgs])
        save_image(os.path.join(cfg.writeto, f"cluster_{ci + 1:02d}.jpg"),
                   _square_grid(tile))

    # --- ④ similarity search (apply_r.lua:169-172, 265-318) ---
    clock.start("stage ④ similarity search")
    needles = torch.tensor([(i + 1) * 100 - 1 for i in range(cfg.needles)],
                           device=device)
    with torch.inference_mode():
        attr_topk = cosine_topk(attributes, needles, 100, cfg.approx,
                                cfg.recall_target)
        pix_topk = pixel_cosine_topk(images, needles, 100, cfg.approx,
                                     cfg.recall_target)
    clock.stop("search", f", approximate at recall target "
               f"{cfg.recall_target}" if cfg.approx else "")
    for tag, (_, idx) in (("attributes", attr_topk),
                          ("pixelwise", pix_topk)):
        idx = idx.cpu().numpy()
        for i in range(cfg.needles):
            tiles = images_host[idx[i]]
            tiles[0] = add_border(tiles[0], BLUE)
            save_image(os.path.join(cfg.writeto,
                                    f"similar_{tag}_{i + 1:02d}.jpg"),
                       _square_grid(tiles))

    # --- ⑤ fixing (apply_r.lua:179-182, 324-352) ---
    clock.start("stage ⑤ fixing")
    fixed = fix_images(g_vars, attributes_fixer, dims=dims,
                       noise_dim=noise_dim, batch_size=batch, dtype=dtype)
    clock.stop("fix")
    n_show = min(NB_FIXED, cfg.N)
    fixed_host = rgb(fixed[:n_show])  # n_show >= the pairs' count
    pairs = np.stack([np.concatenate([images_host[i], fixed_host[i]], axis=1)
                      for i in range(min(NB_PAIRS, cfg.N))])
    save_image(os.path.join(cfg.writeto, "fixed_pairs.jpg"),
               images_to_grid(pairs, math.ceil(len(pairs) / 4), 4))
    save_image(os.path.join(cfg.writeto,
                            f"fixed_images_{NB_FIXED}_unfixed.jpg"),
               _side_grid(images_host[:n_show]))
    save_image(os.path.join(cfg.writeto, f"fixed_images_{NB_FIXED}.jpg"),
               _side_grid(fixed_host[:n_show]))

    # --- ⑥ anomaly detection (apply_r.lua:187-191, 355-390) ---
    clock.start("stage ⑥ anomaly detection")
    n_calc = min(cfg.anomalies_n, cfg.N)
    scores, thr, is_anomaly = detect_anomalies(
        images[:n_calc], fixed[:n_calc], cfg.anomalies_quantile)
    flags = is_anomaly.cpu().numpy()
    clock.stop("anomalies")
    n_show = min(NB_FIXED, n_calc)
    tiles = np.array(images_host[:n_show], copy=True)
    for i in np.nonzero(flags[:n_show])[0]:
        tiles[i] = add_border(tiles[i], RED)
    save_image(os.path.join(cfg.writeto, "anomalies.jpg"), _side_grid(tiles))
    print(f"[apply_r] threshold={thr.item():.4f} "
          f"anomalies={int(flags.sum())}/{n_calc}")

    # run stats into the metrics log
    cluster_sizes = np.bincount(assign_host, minlength=cfg.clusters)
    with MetricsWriter(cfg.writeto, name="apply_r_stats") as writer:
        writer.scalar("n_inverted", cfg.N)
        writer.scalar("anomaly_threshold", thr.item())
        writer.scalar("anomaly_count", int(flags.sum()))
        for ci, size in enumerate(cluster_sizes):
            writer.scalar("cluster_size", int(size), step=ci)
    print(f"[apply_r] ran stages ① to ⑥; artifacts in {cfg.writeto}/")
    return {"attributes": attributes, "attributes_fixer": attributes_fixer,
            "images": images, "variations": variations,
            "centroids": centroids, "counts": counts, "assign": assign,
            "attr_topk": attr_topk, "pix_topk": pix_topk, "fixed": fixed,
            "scores": scores, "threshold": thr, "is_anomaly": is_anomaly,
            "seconds": clock.seconds, "device": device}


if __name__ == "__main__":
    main()
