"""Stage ② of apply_r.lua (143-153): generate N faces and recover their
latents — the non-fixer part of ganreverser_tpu/analysis/pipeline.py::
generate_and_invert, on the fast forwards (models/fastpath.py).

The variation sweep, fixing and anomaly pipelines are not ported yet
(ROADMAP.md, queue A).
"""
from __future__ import annotations

import torch

from ..core.prng import noise_inputs
from ..models.fastpath import make_fast_generator, make_fast_inverter
from .batched import forward_batched


@torch.inference_mode()
def generate_and_invert(g_variables: dict, r_variables: dict, *, dims: tuple,
                        n: int, noise_dim: int, noise_method: str,
                        generator: torch.Generator, batch_size: int = 1024,
                        dtype: torch.dtype = torch.float32):
    """Noise from ``generator`` (on its device) -> fast G -> fast R, in
    chunks of ``batch_size``. The variables are tensor trees on the
    generator's device. Returns (noise, images, attributes)."""
    generate = make_fast_generator(dims, noise_dim, dtype)
    invert = make_fast_inverter(dims, noise_dim, noise_method, dtype)
    noise = noise_inputs(generator, n, noise_dim, noise_method,
                         device=generator.device)
    images = forward_batched(lambda z: generate(g_variables, z), noise,
                             batch_size)
    attributes = forward_batched(lambda x: invert(r_variables, x), images,
                                 batch_size)
    return noise, images, attributes
