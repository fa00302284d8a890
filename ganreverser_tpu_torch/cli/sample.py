"""Offline sampling CLI — sample.lua, the counterpart of
ganreverser_tpu/cli/sample.py, with its artifact names.

Per run (``--runs`` times; with more than one run every file gets a
``_NNNN`` run suffix): ``trainset.jpg`` (64 training images), 1,024 samples
of G as ``samples_256.jpg`` and ``samples_1024.jpg``, the 64 best, worst
and first samples by D's score (``best_64.jpg``, ``worst_64.jpg``,
``random_64.jpg``) and, with ``--neighbours``, ``neighbours.jpg``: the 16
best samples beside their L2-nearest training images, over the whole
training set (sample.lua:130-148) or its first ``--neighbours_max``,
scanned in chunks of 2,048 on the device.

G runs on the fast path (kernel U) and D's evaluation forward on kernel B6
(models/fastpath.py), both in chunks of 256 images; with
GANREVERSER_PLATFORM=cpu their plain versions run. The geometry comes from
the checkpoint's config (a differing flag is warned about).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..analysis.batched import forward_batched
from ..core.config import SampleConfig
from ..core.precision import pinned_precision
from ..core.prng import noise_inputs, stage_generator
from ..io import checkpoint as ckpt
from ..models import bridge
from ..models.fastpath import make_fast_discriminator, make_fast_generator
from ..utils.grids import images_to_grid, save_image
from . import common

N_SAMPLES = 1024
CHUNK = 256               # images per forward of G and D
NEIGHBOUR_CHUNK = 2048    # training images per distance matmul


def nearest_neighbours(best: torch.Tensor, load, n_train: int,
                       chunk: int = NEIGHBOUR_CHUNK):
    """For each row of ``best`` (k, ...) the training image at the least
    squared L2 distance, scanning ``load(start, count)`` (host arrays) in
    chunks with a running minimum. A short last chunk is padded with
    copies of its row 0, as the JAX package pads to its compiled shape, so
    an argmin on a padded row maps back to row 0. Returns (distances,
    images) on the host."""
    best_flat = best.reshape(best.shape[0], -1).float()
    best_d = np.full((best.shape[0],), np.inf, np.float32)
    best_img = None
    for start in range(0, n_train, chunk):
        count = min(chunk, n_train - start)
        imgs_np = load(start, count)
        t = torch.from_numpy(np.ascontiguousarray(imgs_np)).to(best.device)
        if count < chunk and start > 0:
            t = torch.cat([t, t[:1].expand((chunk - count,) + t.shape[1:])])
        t = t.reshape(t.shape[0], -1).float()
        with pinned_precision(torch.float32):
            d = ((best_flat * best_flat).sum(1)[:, None]
                 - 2.0 * best_flat @ t.T + (t * t).sum(1)[None, :])
        v, i = (a.cpu().numpy() for a in torch.min(d, dim=1))
        i = np.where(i >= count, 0, i)
        better = v < best_d
        if best_img is None:
            best_img = np.empty((best.shape[0],) + imgs_np.shape[1:],
                                imgs_np.dtype)
        best_d[better] = v[better]
        best_img[better] = imgs_np[i[better]]
    return best_d, best_img


def main(argv=None) -> dict:
    """Sample; returns the last run's images, D's scores and the order of
    the scores (host arrays)."""
    cfg = SampleConfig.from_args(argv, "offline sampling (sample.lua)")
    device = common.resolve_device()
    dtype = common.compute_dtype(cfg)
    os.makedirs(cfg.writeto, exist_ok=True)

    tree, g_cfg, _ = ckpt.load_checkpoint(cfg.network)
    noise_dim, noise_method = g_cfg["noiseDim"], g_cfg["noiseMethod"]
    colorspace = g_cfg["colorSpace"]
    h, w = g_cfg["height"], g_cfg["width"]
    dims = (1 if colorspace == "y" else 3, h, w)
    # sample.lua:210-217: the checkpoint's geometry wins over the flags
    for attr in ("colorSpace", "height", "width"):
        mine, theirs = getattr(cfg, attr), g_cfg.get(attr)
        if str(mine) != str(theirs):
            print(f"[sample] WARNING: --{attr}={mine} differs from the "
                  f"checkpoint's {attr}={theirs}; using the checkpoint's")
    cfg.height, cfg.width, cfg.colorSpace = h, w, colorspace
    g_vars = bridge.to_torch({k: tree["G"][k] for k in ("params", "state")},
                             device)
    d_vars = bridge.to_torch({k: tree["D"][k] for k in ("params", "state")},
                             device)
    gen_fn = make_fast_generator(dims, noise_dim, dtype)
    rate_fn = make_fast_discriminator(dims, dtype)
    g_prep, d_prep = gen_fn.prepare(g_vars), rate_fn.prepare(d_vars)
    dataset = common.make_dataset(cfg)

    def rgb(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return common.to_nhwc_rgb(x, colorspace)

    for run in range(1, cfg.runs + 1):
        def out(name):
            if cfg.runs > 1:  # sample.lua:83-121's '%04d' patterns
                base, ext = os.path.splitext(name)
                name = f"{base}_{run:04d}{ext}"
            return os.path.join(cfg.writeto, name)

        save_image(out("trainset.jpg"),
                   images_to_grid(rgb(dataset.load_random_images(64)), 8, 8))
        # run r draws its latents from stage 100 + r of --seed
        z = noise_inputs(stage_generator(cfg.seed, 100 + run, device),
                         N_SAMPLES, noise_dim, noise_method, device=device)
        with torch.inference_mode():
            images = forward_batched(lambda b: gen_fn.run(g_prep, b), z,
                                     CHUNK)
            preds = forward_batched(lambda b: rate_fn.run(d_prep, b), images,
                                    CHUNK).reshape(-1).float().cpu().numpy()
        images_host = rgb(images)
        save_image(out("samples_256.jpg"),
                   images_to_grid(images_host[:256], 16, 16))
        save_image(out("samples_1024.jpg"),
                   images_to_grid(images_host, 32, 32))
        order = np.argsort(-preds, kind="stable")
        save_image(out("best_64.jpg"),
                   images_to_grid(images_host[order[:64]], 8, 8))
        save_image(out("worst_64.jpg"),
                   images_to_grid(images_host[order[::-1][:64]], 8, 8))
        save_image(out("random_64.jpg"),
                   images_to_grid(images_host[:64], 8, 8))

        if cfg.neighbours:
            n_train = dataset.size()
            if cfg.neighbours_max > 0:
                n_train = min(n_train, cfg.neighbours_max)
                if n_train < dataset.size():
                    print(f"[sample] --neighbours_max: scanning "
                          f"{n_train}/{dataset.size()} training images")
            best16 = images[torch.from_numpy(order[:16].copy()).to(device)]
            _, best_img = nearest_neighbours(best16, dataset.load_images,
                                             n_train)
            tiles = np.concatenate([rgb(best16), rgb(best_img)])
            save_image(out("neighbours.jpg"), images_to_grid(tiles, 4, 8))
        if cfg.runs > 1:
            print(f"[sample] run {run}/{cfg.runs} done")
    print(f"[sample] artifacts written to {cfg.writeto}/")
    return {"images": images.float().cpu().numpy(), "preds": preds,
            "order": order}


if __name__ == "__main__":
    main()
