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
random numbers from a generator of its own (core/prng.py).

``--mesh_data``/``--mesh_model`` run stage ② on a ('data', 'model') mesh
of ranks (analysis/distributed.py): each rank generates, inverts (and
refines) its rows of the N faces on the fast G and R, G's and R's big
kernels cut over 'model' and gathered once per call; with ``--approx``
stage ④'s two searches run on the ranks' rows too
(``distributed_cosine_topk``), else over the gathered arrays. Stages ①,
③, ⑤ and ⑥ run on rank 0, on the arrays gathered from all ranks, and
rank 0 alone writes files. The JAX CLI has no coordinator flags: started
as one process with a mesh larger than 1, this CLI starts its ranks
itself, one per card (a mesh larger than the visible cards is refused
with make_mesh's message) or, on the CPU, one per mesh place, joined over
a localhost rendezvous; ranks started by torchrun join its world. As in
the JAX package, ``--int8`` is bypassed under a mesh.

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

from .. import parallel as par
from ..analysis.kmeans import assign_min_cosine, cluster_members, kmeans
from ..analysis.pipeline import (detect_anomalies, fix_images,
                                 generate_and_invert, variation_sweep)
from ..analysis.distributed import (distributed_cosine_topk,
                                    distributed_generate_and_invert)
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


def _on_mesh(variables: dict, mesh: par.Mesh) -> tuple:
    """(this rank's variables, their specs): the params cut over 'model'
    by the TP layout rule, the module state replicated."""
    specs = {"params": par.param_specs(variables["params"], mesh),
             "state": {k: {n: par.P() for n in v}
                       for k, v in variables["state"].items()}}
    return {"params": par.shard_params(variables["params"], mesh),
            "state": variables["state"]}, specs


def _launch(cfg: ApplyConfig, argv) -> dict:
    """Start the mesh's ranks (module docstring) and wait for them."""
    if not ckpt.exists(cfg.G):  # fail here, once, not in every rank
        ckpt.load_checkpoint(cfg.G)
    device = common.resolve_device()
    if device.type == "cuda":
        data, model = par.mesh_shape(cfg.mesh_data, cfg.mesh_model,
                                     torch.cuda.device_count())
    else:
        data, model = max(cfg.mesh_data, 1), max(cfg.mesh_model, 1)
    argv = list(sys.argv[1:] if argv is None else argv)
    print(f"[apply_r] starting {data * model} ranks for the ({data} data x "
          f"{model} model) mesh on {device.type}")
    common.launch_ranks("ganreverser_tpu_torch.cli.apply_r",
                        argv + ["--mesh_data", str(data), "--mesh_model",
                                str(model)], data * model)
    return {"ranks": data * model, "writeto": cfg.writeto}


def main(argv=None) -> dict:
    """Run the six stages; returns the recovered latents (plain and fixer),
    the images, the variations, the kmeans centroids, counts and
    assignment, both top-k results, the fixed images, the anomaly scores,
    threshold and flags, the stage times in seconds and the device. A
    process that starts the ranks of a mesh returns their count and the
    output directory; a rank other than 0 returns its rank."""
    cfg = ApplyConfig.from_args(argv, "inversion/analysis suite (apply_r.lua)")
    _check_flags(cfg)
    if ((cfg.mesh_data != 1 or cfg.mesh_model != 1)
            and par.mesh.world()[1] == 1 and "RANK" not in os.environ):
        return _launch(cfg, argv)
    started = par.initialize_distributed()  # the ranks' environment
    try:
        return _apply(cfg)
    finally:
        if started:
            par.shutdown_distributed()


def _check_flags(cfg: ApplyConfig):
    if cfg.N < cfg.needles * 100:
        sys.exit(f"--needles {cfg.needles} requires --N >= "
                 f"{cfg.needles * 100} (needle indices are (i+1)*100-1, "
                 "apply_r.lua:272)")
    if cfg.approx and not 0 < cfg.recall_target <= 1:
        sys.exit(f"--recall_target {cfg.recall_target} must lie in (0, 1]")
    if not 0 < cfg.clusters <= cfg.N:
        sys.exit(f"--clusters {cfg.clusters} must lie in 1..N ({cfg.N})")


def _apply(cfg: ApplyConfig) -> dict:
    device = common.resolve_device()
    dtype = common.compute_dtype(cfg)
    mesh = None
    if cfg.pallas:
        print("[apply_r] note: --pallas is inert: every stage runs on the "
              "port's kernels with or without it")
    if common.wants_mesh(cfg):
        mesh = par.make_mesh(data=cfg.mesh_data, model=cfg.mesh_model)
        if cfg.int8:
            print("[apply_r] note: --int8 is bypassed under "
                  "--mesh_data/--mesh_model>1, as in the JAX package",
                  file=sys.stderr)
    main_rank = par.is_main_process()
    if main_rank:
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
          f"{noise_method}/{noise_dim}, {cfg.compute_dtype} on {device}"
          + (f", mesh {mesh.shape} rank {mesh.rank}" if mesh else ""))
    clock = _StageClock(device)

    def rgb(x: torch.Tensor) -> np.ndarray:
        return to_rgb(x.float().cpu().numpy(), colorspace)

    # --- ① variation sweep (apply_r.lua:115-138), on rank 0 ---
    if main_rank:
        clock.start("stage ① variation sweep")
        variations = variation_sweep(
            g_vars, dims=dims, noise_dim=noise_dim,
            noise_method=noise_method,
            generator=stage_generator(cfg.seed, 1, device),
            nb_steps=NB_STEPS, batch_size=batch, dtype=dtype)
        clock.stop("variations")
        save_image(os.path.join(cfg.writeto, "variations.jpg"),
                   images_to_grid(rgb(variations), noise_dim, NB_STEPS))

    # --- ② generate N + invert (apply_r.lua:143-153) ---
    clock.start("stage ② generate + invert")
    if mesh is None:
        out = generate_and_invert(
            g_vars, r_vars, dims=dims, n=cfg.N, noise_dim=noise_dim,
            noise_method=noise_method,
            generator=stage_generator(cfg.seed, 2, device),
            batch_size=batch, dtype=dtype, rf_variables=rf_vars,
            fixer_generator=stage_generator(cfg.seed, 5, device),
            int8=cfg.int8)
    else:
        # N cut over 'data'; with a 'model' axis each rank keeps its slices
        # of G's, R's and the fixer's big kernels (gathered once per call)
        placed = [_on_mesh(v, mesh) if v is not None else (None, None)
                  for v in (g_vars, r_vars, rf_vars)]
        if not main_rank:
            g_vars = None  # rank 0 keeps the whole G for stages ① and ⑤
        out = distributed_generate_and_invert(
            placed[0][0], placed[1][0], dims=dims, n=cfg.N,
            noise_dim=noise_dim, noise_method=noise_method,
            generator=stage_generator(cfg.seed, 2, device), mesh=mesh,
            batch_size=batch, dtype=dtype, g_specs=placed[0][1],
            r_specs=placed[1][1], rf_variables=placed[2][0],
            rf_specs=placed[2][1],
            fixer_generator=stage_generator(cfg.seed, 5, device))
        del placed
    _, images, attributes = out[:3]
    attributes_fixer = out[3] if rf_vars is not None else attributes
    t = clock.stop("generate_invert")
    print(f"[apply_r]   {images.shape[0]} images ({images.shape[0] / t:.1f} "
          f"img/s){', int8 G and R' if cfg.int8 and mesh is None else ''}"
          f"{', fixer-R included' if rf_vars is not None else ''}")

    # --- optional: gradient-based latent refinement (on each rank's rows:
    # every image is refined on its own) ---
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

    if mesh is not None:
        local = (attributes, images)
        with torch.inference_mode():
            images, attributes, attributes_fixer = (
                par.all_gather(x, mesh) for x in
                (images, attributes, attributes_fixer))
            if cfg.approx:
                # stage ④'s searches on the ranks' rows (JAX: the tested
                # shard_map collective merge for approx under a mesh)
                clock.start("stage ④ similarity search on the mesh")
                needles = torch.tensor(
                    [(i + 1) * 100 - 1 for i in range(cfg.needles)],
                    device=device)
                mesh_topk = [distributed_cosine_topk(
                    x.reshape(x.shape[0], -1), needles, 100, mesh,
                    approx=True, recall_target=cfg.recall_target)
                    for x in local]
                clock.stop("search_mesh")
        if not main_rank:
            print(f"[apply_r] rank {mesh.rank}: stage ② done")
            return {"rank": mesh.rank}

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
        if mesh is not None and cfg.approx:
            attr_topk, pix_topk = mesh_topk
        else:
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
