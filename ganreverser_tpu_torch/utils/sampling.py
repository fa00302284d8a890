"""G/D sampling conveniences — the NN_UTILS helpers (utils/nn_utils.lua)
as library functions, the counterparts of ganreverser_tpu/utils/sampling.py:

  create_images_from_noise  <- nn_utils.createImagesFromNoise (:57-81)
  create_images             <- nn_utils.createImages (:87-89)
  sort_images_by_prediction <- nn_utils.sortImagesByPrediction (:101-129)
  to_batch / to_image_tensor<- nn_utils.toBatch/toImageTensor (:248-307)

G runs on the fast G (kernel U and U's fused head) and D on the fast D
(kernel B6), in evaluation, over ``analysis/batched.forward_batched``; on
CPU tensors their plain versions run. The JAX functions apply the
modules. The variables are ``{"params", "state"}`` trees of tensors on
the inputs' device (``models/bridge.py::module_variables`` or
``to_torch``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..analysis.batched import forward_batched
from ..core.prng import noise_inputs
from ..models.fastpath import make_fast_discriminator, make_fast_generator


def _g3_geometry(G: nn.Module) -> tuple:
    """((C, H, W), noise_dim, dtype) of a ``zoo.create_G3`` module."""
    sh, sw, _ = G.l3.shape
    return ((G.l12.kernel.shape[-1], 4 * sh, 4 * sw), G.l0.kernel.shape[0],
            G.l0.dtype)


@torch.no_grad()
def create_images_from_noise(G: nn.Module, g_variables: dict,
                             noise: torch.Tensor,
                             batch_size: int = 256) -> torch.Tensor:
    """Batched evaluation forward of the G3 ``G`` (its geometry and compute
    dtype) on ``g_variables`` over ``noise``: NHWC images in G's dtype."""
    dims, noise_dim, dtype = _g3_geometry(G)
    fast_g = make_fast_generator(dims, noise_dim, dtype)
    prepared = fast_g.prepare(g_variables)
    return forward_batched(lambda z: fast_g.run(prepared, z), noise,
                           batch_size)


def create_images(G: nn.Module, g_variables: dict, n: int, *, noise_dim: int,
                  noise_method: str, generator: torch.Generator,
                  batch_size: int = 256) -> torch.Tensor:
    """``n`` images from latents drawn from ``generator`` (on its
    device)."""
    z = noise_inputs(generator, n, noise_dim, noise_method,
                     device=generator.device)
    return create_images_from_noise(G, g_variables, z, batch_size)


@torch.no_grad()
def sort_images_by_prediction(D: nn.Module, d_variables: dict,
                              images: torch.Tensor, *,
                              ascending: bool = False,
                              nb_max_out: Optional[int] = None,
                              batch_size: int = 256):
    """Rank NHWC ``images`` by the D2 ``D``'s realness score (its compute
    dtype, ``d_variables``'s weights). Descending (default) starts with the
    most 'real' images (nn_utils.lua:91-129). Returns (sorted_images,
    sorted_predictions), truncated to nb_max_out; ties keep their order."""
    _, h, w, c = images.shape
    rate = make_fast_discriminator((c, h, w), D.l0.l0.dtype)
    prepared = rate.prepare(d_variables)
    preds = forward_batched(lambda x: rate.run(prepared, x).reshape(-1),
                            images, batch_size)
    order = torch.argsort(preds if ascending else -preds, stable=True)
    if nb_max_out is not None:
        order = order[:nb_max_out]
    return images[order], preds[order]


def to_batch(image: np.ndarray) -> np.ndarray:
    """Add a leading batch dim (nn_utils.toBatch)."""
    return np.asarray(image)[None]


def to_image_tensor(images, force_channel: bool = False) -> np.ndarray:
    """Coerce a list/array of images to one (N, H, W, C) array
    (nn_utils.toImageTensor; NHWC here instead of NCHW)."""
    arr = np.stack([np.asarray(im) for im in images]) \
        if isinstance(images, (list, tuple)) else np.asarray(images)
    if force_channel and arr.ndim == 3:
        arr = arr[..., None]
    return arr
