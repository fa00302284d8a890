"""Inversion/analysis suite CLI — apply_r.lua, the counterpart of
ganreverser_tpu/cli/apply_r.py.

Ported stages:
  ② generate N faces with G and recover their latents with R
    (apply_r.lua:143-153), through the fast forwards (models/fastpath.py);
  ④ cosine top-k over the recovered latents and over raw pixels
    (apply_r.lua:169-172, 265-318), writing similar_attributes_NN.jpg and
    similar_pixelwise_NN.jpg.
Stages ① (variation sweep), ③ (clustering), ⑤ (fixing) and ⑥ (anomalies)
are not ported yet: each is skipped with a printed line naming its ROADMAP
item. Flags of modes the port does not have are refused.

It reads the checkpoints the JAX package writes (io/checkpoint.py). On CUDA
(GANREVERSER_PLATFORM unset or gpu) G, R and the search run through the
hand-written kernels; with GANREVERSER_PLATFORM=cpu their plain versions
run.

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

from ..analysis.pipeline import generate_and_invert
from ..analysis.similarity import cosine_topk, pixel_cosine_topk
from ..core.config import ApplyConfig
from ..core.prng import seeded_generator
from ..data.colorspace import to_rgb
from ..io import checkpoint as ckpt
from ..models.bridge import to_torch
from ..utils.grids import BLUE, add_border, images_to_grid, save_image
from . import common

_NOT_PORTED = {
    "①": ("variation sweep", "ROADMAP.md queue A item 6"),
    "③": ("clustering", "ROADMAP.md queue A item 5"),
    "⑤": ("fixing", "ROADMAP.md queue A item 6"),
    "⑥": ("anomaly detection", "ROADMAP.md queue A item 6"),
}


def _square_grid(images_rgb: np.ndarray):
    n = images_rgb.shape[0]
    side = math.ceil(math.sqrt(n))
    return images_to_grid(images_rgb, math.ceil(n / side), side)


def _refuse_unported(cfg: ApplyConfig):
    refused = [flag for flag, on in (
        ("--int8", cfg.int8), ("--approx", cfg.approx),
        ("--refine_steps > 0", cfg.refine_steps > 0),
        ("--mesh_data > 1", cfg.mesh_data > 1),
        ("--mesh_model > 1", cfg.mesh_model > 1)) if on]
    if refused:
        sys.exit(f"[apply_r] not ported yet: {', '.join(refused)} "
                 "(ROADMAP.md, queue A)")


def _skip(stage: str):
    what, item = _NOT_PORTED[stage]
    print(f"[apply_r] stage {stage} {what}: skipped, not ported yet ({item})")


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the ported stages; returns the recovered latents, the images,
    both top-k results, the stage times in seconds and the device."""
    cfg = ApplyConfig.from_args(argv, "inversion/analysis suite (apply_r.lua)")
    _refuse_unported(cfg)
    device = common.resolve_device()
    dtype = common.compute_dtype(cfg)
    if cfg.N < cfg.needles * 100:
        sys.exit(f"--needles {cfg.needles} requires --N >= "
                 f"{cfg.needles * 100} (needle indices are (i+1)*100-1, "
                 "apply_r.lua:272)")
    os.makedirs(cfg.writeto, exist_ok=True)

    # --- load G (inherit geometry) + R (apply_r.lua:59-109) ---
    g_tree, g_cfg, _ = ckpt.load_checkpoint(cfg.G)
    noise_dim = g_cfg["noiseDim"]
    noise_method = g_cfg["noiseMethod"]
    colorspace = g_cfg["colorSpace"]
    h, w = g_cfg["height"], g_cfg["width"]
    c = 1 if colorspace == "y" else 3
    dims = (c, h, w)
    r_path = cfg.R or ckpt.r_name(cfg.save, c, h, w, noise_dim, noise_method,
                                  False)
    r_tree, _, _ = ckpt.load_checkpoint(r_path)
    g_vars = to_torch({"params": g_tree["G"]["params"],
                       "state": g_tree["G"]["state"]}, device)
    r_vars = to_torch({"params": r_tree["R"]["params"],
                       "state": r_tree["R"]["state"]}, device)
    print(f"[apply_r] G {cfg.G}, R {r_path}: {c}x{h}x{w}, noise "
          f"{noise_method}/{noise_dim}, {cfg.compute_dtype} on {device}")

    _skip("①")

    # --- ② generate N + invert (apply_r.lua:143-153) ---
    print("[apply_r] stage ② generate + invert")
    _sync(device)
    t0 = time.perf_counter()
    _, images, attributes = generate_and_invert(
        g_vars, r_vars, dims=dims, n=cfg.N, noise_dim=noise_dim,
        noise_method=noise_method,
        generator=seeded_generator(cfg.seed, device),
        batch_size=max(cfg.batchSize, 256), dtype=dtype)
    _sync(device)
    t_gen_inv = time.perf_counter() - t0
    print(f"[apply_r]   {cfg.N} images in {t_gen_inv:.3f} s "
          f"({cfg.N / t_gen_inv:.1f} img/s)")

    _skip("③")

    # --- ④ similarity search (apply_r.lua:169-172, 265-318) ---
    print("[apply_r] stage ④ similarity search")
    needles = torch.tensor([(i + 1) * 100 - 1 for i in range(cfg.needles)],
                           device=device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        attr_topk = cosine_topk(attributes, needles, 100)
        pix_topk = pixel_cosine_topk(images, needles, 100)
    _sync(device)
    t_search = time.perf_counter() - t0
    print(f"[apply_r]   2 searches of {cfg.needles} needles over {cfg.N} rows "
          f"in {t_search * 1e3:.2f} ms")
    images_host = to_rgb(images.float().cpu().numpy(), colorspace)
    for tag, (_, idx) in (("attributes", attr_topk),
                          ("pixelwise", pix_topk)):
        idx = idx.cpu().numpy()
        for i in range(cfg.needles):
            tiles = images_host[idx[i]]
            tiles[0] = add_border(tiles[0], BLUE)
            save_image(os.path.join(cfg.writeto,
                                    f"similar_{tag}_{i + 1:02d}.jpg"),
                       _square_grid(tiles))

    _skip("⑤")
    _skip("⑥")
    print(f"[apply_r] ran stages ② ④; artifacts in {cfg.writeto}/")
    return {"attributes": attributes, "images": images,
            "attr_topk": attr_topk, "pix_topk": pix_topk,
            "seconds": {"generate_invert": t_gen_inv, "search": t_search},
            "device": device}


if __name__ == "__main__":
    main()
