"""Latent noise from an explicit ``torch.Generator``.

The JAX package derives every random draw from one ``jax.random`` key and
folds a stage number into it (apply_r: 1 variations, 2 generation, 3 kmeans
init, 5 the fixer's dropout). Here each stage draws from a generator of its
own, seeded from (``--seed``, stage number) by :func:`stage_seed`, so adding
or skipping one stage changes no other stage's numbers. A trainer takes
stages too (:func:`trainer_generators`). The two frameworks
give different numbers for one seed, so tests hand both the same numpy
draws.
"""
from __future__ import annotations

import torch


def seeded_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def stage_seed(seed: int, stage: int) -> int:
    """The seed of stage ``stage``: ``seed`` + (stage - 2) * 2**32, modulo
    2**64. Stage 2, the generation of the N faces, keeps ``seed`` itself."""
    return (seed + ((stage - 2) << 32)) % (1 << 64)


def stage_generator(seed: int, stage: int,
                    device: torch.device) -> torch.Generator:
    """A generator on ``device`` for stage ``stage`` of a run seeded with
    ``seed``."""
    return seeded_generator(stage_seed(seed, stage), device)


# the stages of a training run (train_r, train): the initial weights (drawn
# on the CPU; train draws G's, then D's), the latents of the training steps
# (train: D's fake halves and G's batches, in step order), the dropout
# masks or seeds (R's; D's), and the latents and fixer masks of the previews
# (train: the fixed visualisation noise)
INIT_STAGE, NOISE_STAGE, DROPOUT_STAGE, PREVIEW_STAGE = 1, 2, 5, 7


def trainer_generators(seed: int, device: torch.device):
    """(noise, dropout) generators on ``device`` for a training run seeded
    with ``seed``: one stream for the batches' latents, one for the
    dropouts."""
    return (stage_generator(seed, NOISE_STAGE, device),
            stage_generator(seed, DROPOUT_STAGE, device))


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
