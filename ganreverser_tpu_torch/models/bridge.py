"""Weights carried between the JAX variable trees and the port's modules.

A JAX model's variables are ``{"params": ..., "state": ...}`` trees keyed by
layer (``l0``, ``l1``, ...; nested Sequentials nest). The port's modules
keep the same names and layouts (models/modules.py), so the mapping is one
to one: ``<path>.kernel``/``bias``/``scale`` come from ``params[path]`` and
the BatchNorm buffers ``<path>.mean``/``var`` from ``state[path]``. Conv
kernels stay HWIO and Dense kernels (in, out) on both sides.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

_STATE_LEAVES = ("mean", "var")


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def load_jax_variables(module: nn.Module, variables: dict) -> nn.Module:
    """Copy ``variables`` (a JAX-layout tree of numpy arrays or tensors)
    into ``module``. Raises on a missing leaf, a shape mismatch or a leaf
    the module has no place for."""
    own = module.state_dict()
    new = {}
    for key, ref in own.items():
        *path, leaf = key.split(".")
        node = variables["state" if leaf in _STATE_LEAVES else "params"]
        try:
            for p in path:
                node = node[p]
            value = node[leaf]
        except KeyError as e:
            raise KeyError(f"variables have no leaf for {key!r}") from e
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: variables have shape {tuple(t.shape)}, "
                             f"module expects {tuple(ref.shape)}")
        new[key] = t
    n_tree = (_count_leaves(variables.get("params", {}))
              + _count_leaves(variables.get("state", {})))
    if n_tree != len(own):
        raise ValueError(f"variables hold {n_tree} leaves, module has "
                         f"{len(own)}: the architectures differ")
    module.load_state_dict(new, strict=True)
    return module


def export_variables(module: nn.Module) -> dict:
    """The inverse: ``{"params", "state"}`` of f32 numpy arrays, loadable by
    the JAX model of the same architecture."""
    out = {"params": {}, "state": {}}
    for key, t in module.state_dict().items():
        *path, leaf = key.split(".")
        node = out["state" if leaf in _STATE_LEAVES else "params"]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().float().numpy()
    return out


def to_torch(tree, device: torch.device | str):
    """A tree of arrays as f32 tensors on ``device`` (dicts kept)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, dtype=np.float32), device=device)
