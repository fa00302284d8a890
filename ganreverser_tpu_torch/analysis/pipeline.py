"""The inversion/analysis pipelines of apply_r.lua, the counterparts of
ganreverser_tpu/analysis/pipeline.py, on the fast forwards
(models/fastpath.py): ① the variation sweep, ② generate + invert (and the
fixer-R), ⑤ fixing and ⑥ the anomaly scores. Grids and borders stay on the
host in the CLI. Each call prepares each fast forward's weights once
(``prepare``: BatchNorm folded, weights rounded or quantised and laid out)
and runs it per chunk.
"""
from __future__ import annotations

import torch

from ..core.prng import noise_inputs
from ..models.fastpath import (make_fast_fixer, make_fast_generator,
                               make_fast_generator_int8, make_fast_inverter,
                               make_fast_inverter_int8)
from .batched import forward_batched


def variation_noise(base: torch.Tensor, noise_method: str,
                    nb_steps: int = 16) -> torch.Tensor:
    """(noise_dim * nb_steps, noise_dim): ``base`` repeated; row
    ``i * nb_steps + j`` sets component i to step j of linspace(-3, 3) for
    normal noise, (-1, 1) for uniform (apply_r.lua:115-138)."""
    lo, hi = (-1.0, 1.0) if noise_method == "uniform" else (-3.0, 3.0)
    nd = base.shape[0]
    steps = torch.linspace(lo, hi, nb_steps, device=base.device)
    noise = base.float().repeat(nd * nb_steps, 1)
    rows = torch.arange(nd * nb_steps, device=base.device)
    noise[rows, rows // nb_steps] = steps.repeat(nd)
    return noise


@torch.inference_mode()
def variation_sweep(g_variables: dict, *, dims: tuple, noise_dim: int,
                    noise_method: str,
                    generator: torch.Generator | None = None,
                    base: torch.Tensor | None = None, nb_steps: int = 16,
                    batch_size: int = 256,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """① the latent-component sweep through the fast G: one base vector
    (drawn from ``generator``, or ``base`` when given), see
    :func:`variation_noise`. Returns (noise_dim * nb_steps, H, W, C)."""
    if base is None:
        base = noise_inputs(generator, 1, noise_dim, noise_method,
                            device=generator.device)[0]
    generate = make_fast_generator(dims, noise_dim, dtype)
    prep = generate.prepare(g_variables)
    return forward_batched(lambda z: generate.run(prep, z),
                           variation_noise(base, noise_method, nb_steps),
                           batch_size)


@torch.inference_mode()
def generate_and_invert(g_variables: dict, r_variables: dict, *, dims: tuple,
                        n: int, noise_dim: int, noise_method: str,
                        generator: torch.Generator, batch_size: int = 1024,
                        dtype: torch.dtype = torch.float32,
                        rf_variables: dict | None = None,
                        fixer_generator: torch.Generator | None = None,
                        int8: bool = False):
    """② noise from ``generator`` (on its device) -> fast G -> fast R, in
    chunks of ``batch_size``; with ``rf_variables`` also the fast fixer-R,
    whose dropout masks come from ``fixer_generator``, a fresh one per
    chunk. ``int8``: G and R on the int8 legs (the activation scales are
    per chunk, so the chunking is part of the result), the fixer-R as
    without it. The variables are tensor trees on the generator's device.
    Returns (noise, images, attributes[, attributes_fixer])."""
    if int8:
        generate = make_fast_generator_int8(dims, noise_dim, dtype)
        invert = make_fast_inverter_int8(dims, noise_dim, noise_method, dtype)
    else:
        generate = make_fast_generator(dims, noise_dim, dtype)
        invert = make_fast_inverter(dims, noise_dim, noise_method, dtype)
    noise = noise_inputs(generator, n, noise_dim, noise_method,
                         device=generator.device)
    g_prep = generate.prepare(g_variables)
    images = forward_batched(lambda z: generate.run(g_prep, z), noise,
                             batch_size)
    r_prep = invert.prepare(r_variables)
    attributes = forward_batched(lambda x: invert.run(r_prep, x), images,
                                 batch_size)
    if rf_variables is None:
        return noise, images, attributes
    invert_fixer = make_fast_fixer(dims, noise_dim, noise_method, dtype)
    rf_prep = invert_fixer.prepare(rf_variables)
    attributes_fixer = forward_batched(
        lambda x: invert_fixer.run(rf_prep, x, fixer_generator), images,
        batch_size)
    return noise, images, attributes, attributes_fixer


@torch.inference_mode()
def fix_images(g_variables: dict, recovered_z: torch.Tensor, *, dims: tuple,
               noise_dim: int, batch_size: int = 1024,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """⑤ G∘R fixing (apply_r.lua:324-352): the fast G on the recovered
    latents, in chunks of ``batch_size``."""
    generate = make_fast_generator(dims, noise_dim, dtype)
    prep = generate.prepare(g_variables)
    return forward_batched(lambda z: generate.run(prep, z), recovered_z,
                           batch_size)


def anomaly_scores(images: torch.Tensor, fixed: torch.Tensor) -> torch.Tensor:
    """⑥ 1 - ||image - fixed||_2 over all pixels, in f32
    (apply_r.lua:360-369); higher is more normal."""
    d = (images.float() - fixed.float()).reshape(images.shape[0], -1)
    return 1.0 - torch.sqrt((d * d).sum(1))


def anomaly_threshold(scores: torch.Tensor,
                      quantile: float = 0.15) -> torch.Tensor:
    """Element floor(N q) of the ascending sort, 1-based (apply_r.lua:
    371-372): ``sorted[max(int(N q) - 1, 0)]``."""
    idx = max(int(scores.shape[0] * quantile) - 1, 0)
    return torch.sort(scores).values[idx]


def detect_anomalies(images: torch.Tensor, fixed: torch.Tensor,
                     quantile: float = 0.15):
    """(scores, threshold, is_anomaly): an anomaly iff score <= threshold
    (apply_r.lua:374-377)."""
    scores = anomaly_scores(images, fixed)
    thr = anomaly_threshold(scores, quantile)
    return scores, thr, scores <= thr
