"""Typed configs replacing the reference's per-script ``lapp`` flag blocks,
vendored from ganreverser_tpu/core/config.py (same flags, same defaults).
Only the configs of the ported entry points are here; the others come with
their CLIs.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field, fields
from typing import Type, TypeVar

T = TypeVar("T", bound="Config")


@dataclass
class Config:
    """Base: argparse wiring shared by all entry points."""

    @classmethod
    def parser(cls: Type[T], description: str = "") -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(description=description)
        for f in fields(cls):
            arg = "--" + f.name
            if f.type in ("bool", bool) or isinstance(f.default, bool):
                p.add_argument(arg, action="store_true", default=f.default,
                               help=f.metadata.get("help", ""))
            else:
                typ = type(f.default) if f.default is not None else str
                p.add_argument(arg, type=typ, default=f.default,
                               help=f.metadata.get("help", ""))
        return p

    @classmethod
    def from_args(cls: Type[T], argv=None, description: str = "") -> T:
        ns = cls.parser(description).parse_args(argv)
        return cls(**vars(ns))


def _f(default, help=""):
    return field(default=default, metadata={"help": help})


@dataclass
class ApplyConfig(Config):
    """Flags of apply_r.lua:13-23 plus the JAX package's additions. The port
    refuses the flags of modes it does not have yet (--int8, --approx,
    --mesh_* > 1) rather than ignoring them."""
    save: str = _f("logs", "directory with checkpoints / for outputs")
    G: str = _f("logs/adversarial", "G checkpoint")
    R: str = _f("", "R checkpoint (default derived from G's geometry)")
    R_fixer: str = _f("", "fixer-R checkpoint (default derived from G's geometry; plain R when absent)")
    writeto: str = _f("apply_r_results", "output directory for images")
    batchSize: int = _f(32, "inference batch size (chunks are at least 256)")
    N: int = _f(10000, "number of faces to generate + invert (apply_r.lua:145)")
    clusters: int = _f(20, "kmeans cluster count (apply_r.lua:158)")
    kmeans_iters: int = _f(15, "kmeans iterations (apply_r.lua:158)")
    needles: int = _f(5, "similarity-search needle count (apply_r.lua:169)")
    anomalies_n: int = _f(1024, "images scored for anomalies (apply_r.lua:187)")
    anomalies_quantile: float = _f(0.15, "anomaly threshold quantile")
    seed: int = _f(1, "RNG seed")
    refine_steps: int = _f(0, "gradient-based latent refinement steps (0 = off)")
    refine_lr: float = _f(0.05, "refinement learning rate (adam on z)")
    mesh_data: int = _f(1, "data-parallel axis (not ported yet: must be 1)")
    mesh_model: int = _f(1, "tensor-parallel axis (not ported yet: must be 1)")
    int8: bool = _f(False, "int8 serving mode (not ported yet: refused)")
    approx: bool = _f(False, "approximate top-k selection (not ported yet: refused)")
    recall_target: float = _f(0.95, "per-row recall target for --approx")
    compute_dtype: str = _f("float32", "compute dtype: float32|bfloat16")
