"""Weights and train state carried between the JAX trees and the port.

A JAX model's variables are ``{"params": ..., "state": ...}`` trees keyed by
layer (``l0``, ``l1``, ...; nested Sequentials nest). The port's modules
keep the same names and layouts (models/modules.py), so the mapping is one
to one: ``<path>.kernel``/``bias``/``scale`` come from ``params[path]`` and
the BatchNorm buffers ``<path>.mean``/``var`` from ``state[path]``. Conv
kernels stay HWIO and Dense kernels (in, out) on both sides. Optimizer
moments are trees of the params' shape, so a list aligned with
``module.parameters()`` maps by the same names (:func:`nest_by_name`,
:func:`take_by_name`). Float leaves become f32, integer leaves (step
counts) int32.
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


def leaf_array(value) -> np.ndarray:
    """A leaf (array, tensor or number) as a new numpy array: int32 for
    integers, f32 for every other."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    a = np.asarray(value)
    return a.astype(np.int32 if np.issubdtype(a.dtype, np.integer)
                    else np.float32)


def _lookup(tree: dict, key: str):
    node = tree
    try:
        for p in key.split("."):
            node = node[p]
    except KeyError as e:
        raise KeyError(f"tree has no leaf for {key!r}") from e
    return node


def _nest(flat: dict, leaf_fn) -> dict:
    out: dict = {}
    for key, t in flat.items():
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = leaf_fn(t)
    return out


def nest_by_name(flat: dict) -> dict:
    """``{"l0.kernel": t, ...}`` as the nested tree ``{"l0": {"kernel":
    a}}`` of numpy arrays."""
    return _nest(flat, leaf_array)


def take_by_name(tree: dict, names, device) -> list:
    """The leaves of ``tree`` at the dotted ``names``, in their order, as
    tensors on ``device``."""
    return [torch.as_tensor(leaf_array(_lookup(tree, n)), device=device)
            for n in names]


def load_jax_variables(module: nn.Module, variables: dict) -> nn.Module:
    """Copy ``variables`` (a JAX-layout tree of numpy arrays or tensors)
    into ``module``. Raises on a missing leaf, a shape mismatch or a leaf
    the module has no place for."""
    own = module.state_dict()
    new = {}
    for key, ref in own.items():
        leaf = key.rsplit(".", 1)[-1]
        part = variables["state" if leaf in _STATE_LEAVES else "params"]
        t = torch.from_numpy(leaf_array(_lookup(part, key)))
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


def _parts(module: nn.Module) -> dict:
    parts: dict = {"params": {}, "state": {}}
    for key, t in module.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        parts["state" if leaf in _STATE_LEAVES else "params"][key] = t
    return parts


def export_variables(module: nn.Module) -> dict:
    """The inverse: ``{"params", "state"}`` of numpy arrays, loadable by
    the JAX model of the same architecture."""
    return {part: nest_by_name(flat) for part, flat in _parts(module).items()}


def module_variables(module: nn.Module) -> dict:
    """``{"params", "state"}`` of the module's own tensors (detached, on its
    device, not copied), the tree the fast forwards of models/fastpath.py
    take."""
    return {part: _nest(flat, lambda t: t)
            for part, flat in _parts(module).items()}


def to_torch(tree, device: torch.device | str):
    """A tree of arrays as tensors on ``device`` (dicts kept): f32, integer
    leaves int32."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return torch.as_tensor(leaf_array(tree), device=device)
