"""The checkpoint directory format of ganreverser_tpu/io/checkpoint.py, read
and written with numpy and json only.

A checkpoint is a directory holding ``manifest.json`` (a JSON skeleton of
the tree whose array leaves are ``"@npz:<key>"`` references and whose tuples
are ``{"__tuple__": [...]}``, plus the run config and extra metadata) and
``arrays.npz`` (the arrays by key). Checkpoints written by either package
load in the other. Leaves may be numpy arrays or torch tensors; loading
gives numpy arrays (``models/bridge.py`` moves them into modules).

:func:`save_checkpoint_async` (``--async_save``) writes in a background
thread: at most one save is in flight, the tree is copied to the host
first, and an error surfaces at the next save or at
:func:`wait_for_saves`.
"""
from __future__ import annotations

import atexit
import copy
import json
import os
import shutil
import sys
import threading
from typing import Any, Optional

import numpy as np
import torch

_LEAF = "@npz:"


def _encode(tree, arrays: dict, prefix: str):
    """Recursively encode a tree into a JSON skeleton + npz array dict."""
    if isinstance(tree, dict):
        return {k: _encode(v, arrays, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        enc = [_encode(v, arrays, f"{prefix}/{i}") for i, v in enumerate(tree)]
        return {"__tuple__": enc} if isinstance(tree, tuple) else enc
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    key = prefix.lstrip("/") or "root"
    arrays[key] = np.asarray(tree)
    return _LEAF + key


def _decode(skel, arrays):
    if isinstance(skel, dict):
        if "__tuple__" in skel and len(skel) == 1:
            return tuple(_decode(v, arrays) for v in skel["__tuple__"])
        return {k: _decode(v, arrays) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_decode(v, arrays) for v in skel]
    if isinstance(skel, str) and skel.startswith(_LEAF):
        return arrays[skel[len(_LEAF):]]
    return skel


def save_checkpoint(path: str, tree: Any, *, config: Optional[dict] = None,
                    extra: Optional[dict] = None,
                    backup_old: bool = True) -> str:
    """Save ``tree`` to directory ``path`` (written to ``<path>.tmp`` and
    renamed into place; an existing checkpoint becomes ``<path>.old``, or
    is removed when ``backup_old`` is false). ``config``: JSON-serialisable
    run config; ``extra``: small JSON metadata."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays: dict = {}
    manifest = {"skeleton": _encode(tree, arrays, ""), "config": config or {},
                "extra": extra or {}, "format": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)

    if os.path.exists(path):
        if backup_old:
            old = path + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(path, old)
        else:
            shutil.rmtree(path)
    os.rename(tmp, path)
    return path


class _AsyncSaver:
    """The one in-flight background save of the process and the error of
    the last one that failed."""

    def __init__(self):
        self.lock = threading.Lock()
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def join(self) -> Optional[BaseException]:
        """Wait for the in-flight save; returns (and clears) the stored
        error."""
        with self.lock:
            t, self.thread = self.thread, None
        if t is not None:
            t.join()
        err, self.error = self.error, None
        return err

    def start(self, work) -> None:
        def run():
            try:
                work()
            except BaseException as e:  # noqa: BLE001 - raised at the join
                self.error = e

        # not a daemon: an interpreter that exits while the writer renames
        # would otherwise kill it half-way and leave only <path>.old
        t = threading.Thread(target=run, name="ckpt-save", daemon=False)
        with self.lock:
            self.thread = t
        t.start()


_SAVER = _AsyncSaver()


def _report_at_exit():
    err = _SAVER.join()
    if err is not None:
        print(f"[checkpoint] background save failed: {err!r}",
              file=sys.stderr)


atexit.register(_report_at_exit)


def wait_for_saves() -> None:
    """Join the in-flight async save; re-raise its error here (the train
    CLIs call this before they exit, so a failed background write is never
    dropped)."""
    err = _SAVER.join()
    if err is not None:
        raise err


def _host_copy(tree):
    """``tree`` with every tensor and array leaf copied to a host numpy
    array: ``.cpu()`` of a CPU tensor is the same storage, which the next
    step's in-place update would change while the thread writes it."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_host_copy(v) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def save_checkpoint_async(path: str, tree: Any, *,
                          config: Optional[dict] = None,
                          extra: Optional[dict] = None,
                          backup_old: bool = True) -> str:
    """:func:`save_checkpoint` with the file writes in a background thread.

    Joins the previous save first (one in flight, so the ``.old`` backups
    stay in order) and raises its error, copies the tree, config and extra
    to the host here, then writes and renames in the thread. An error of
    this save surfaces at the next call or at :func:`wait_for_saves`."""
    wait_for_saves()
    host_tree = _host_copy(tree)
    config, extra = copy.deepcopy(config), copy.deepcopy(extra)
    _SAVER.start(lambda: save_checkpoint(path, host_tree, config=config,
                                         extra=extra, backup_old=backup_old))
    return path


def load_checkpoint(path: str):
    """Returns (tree, config, extra); the tree's array leaves are numpy."""
    path = os.path.abspath(path)
    if not exists(path):
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (expected a directory containing "
            "manifest.json + arrays.npz — check --save/--G/--R paths)")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    tree = _decode(manifest["skeleton"], arrays)
    return tree, manifest.get("config", {}), manifest.get("extra", {})


def exists(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "manifest.json"))


def retain(path: str, keep: int) -> None:
    """Keep the newest ``keep`` ``<path>.step<E>`` siblings of ``path``
    (numeric order, so step10 outlives step9) and remove the others."""
    base = os.path.basename(path)
    parent = os.path.dirname(path)

    def step_of(name: str) -> int:
        try:
            return int(name[len(base + ".step"):])
        except ValueError:
            return -1

    sibs = sorted(
        (d for d in os.listdir(parent)
         if d.startswith(base + ".step") and
         os.path.isdir(os.path.join(parent, d))),
        key=step_of)
    for d in sibs[:-keep] if keep > 0 else sibs:
        shutil.rmtree(os.path.join(parent, d))


# -- filename conventions (train_r.lua:232, train.lua:241-257) -------------

def adversarial_name(save_dir: str) -> str:
    return os.path.join(save_dir, "adversarial")


def r_name(save_dir: str, c: int, h: int, w: int, noise_dim: int,
           method: str, fixer: bool) -> str:
    """r_<C>x<H>x<W>_nd<z>_<method>[_fixer]."""
    suffix = "_fixer" if fixer else ""
    return os.path.join(save_dir, f"r_{c}x{h}x{w}_nd{noise_dim}_{method}{suffix}")


def g_pretrained_name(save_dir: str, c: int, h: int, w: int,
                      noise_dim: int) -> str:
    """pretrain_g.lua:191-202 / train.lua:148."""
    return os.path.join(save_dir, f"g_pretrained_{c}x{h}x{w}_nd{noise_dim}")


def pretrained_name(save_dir: str, c: int, h: int, w: int,
                    noise_dim: int) -> str:
    """pretrain_with_previous_net.lua:260-266 / train.lua:127."""
    return os.path.join(save_dir, f"pretrained_{c}x{h}x{w}_nd{noise_dim}")
