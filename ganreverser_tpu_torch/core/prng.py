"""Latent noise from an explicit ``torch.Generator``.

The JAX package derives every random draw from one ``jax.random`` key; here
each stage takes a generator seeded from ``--seed``. The two frameworks give
different numbers for one seed, so tests hand both the same numpy draws.
"""
from __future__ import annotations

import torch


def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def noise_inputs(generator: torch.Generator, n: int, noise_dim: int,
                 method: str = "normal", device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sample (n, noise_dim) latent vectors on ``device`` (the generator's
    device) as NN_UTILS.createNoiseInputs does: ``normal`` ~ N(0, 1),
    ``uniform`` ~ U(-1, 1)."""
    if method == "normal":
        return torch.randn((n, noise_dim), generator=generator, device=device,
                           dtype=dtype)
    if method == "uniform":
        u = torch.rand((n, noise_dim), generator=generator, device=device,
                       dtype=dtype)
        return u * 2.0 - 1.0
    raise ValueError(f"Unknown noise method {method!r}")
