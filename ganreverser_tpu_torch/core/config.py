"""Typed configs replacing the reference's per-script ``lapp`` flag blocks,
vendored from ganreverser_tpu/core/config.py (same flags, same defaults).
Only the configs of the ported entry points are here; the others come with
their CLIs.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field, fields
from typing import Type, TypeVar

T = TypeVar("T", bound="Config")


@dataclass
class Config:
    """Base: argparse wiring shared by all entry points."""

    def to_dict(self) -> dict:
        """The flags as a JSON-serialisable dict (saved in checkpoints)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls: Type[T], d: dict) -> T:
        """A config from a dict (a checkpoint's, or a Torch7 file's saved
        ``opt``): unknown keys are ignored, missing ones keep their
        defaults."""
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

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

    def img_dims(self) -> tuple:
        """(C, H, W) of a config with colorSpace/height/width; one channel
        for the 'y' colour space."""
        return (1 if self.colorSpace == "y" else 3, self.height, self.width)


def _f(default, help=""):
    return field(default=default, metadata={"help": help})


@dataclass
class ApplyConfig(Config):
    """Flags of apply_r.lua:13-23 plus the JAX package's additions.
    --pallas is accepted and inert (the port's stages run on its kernels
    with or without it)."""
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
    mesh_data: int = _f(1, "shard the N-axis of generation/inversion/search over this many devices (SURVEY.md §5.7 large-N path)")
    mesh_model: int = _f(1, "tensor-parallel axis: shard G/R's big Dense kernels over this many devices (the 128x128/z=256 workload, SURVEY.md §7 step 6); composes with --mesh_data")
    pallas: bool = _f(False, "accepted for the JAX CLI's sake and inert: the JAX package's fused Pallas paths are the port's default, every stage runs on its hand-written kernels either way")
    int8: bool = _f(False, "int8 serving mode: stage ② on the int8 G and R (ops/quant.py)")
    approx: bool = _f(False, "approximate top-k selection in stage ④'s two searches (kernel S, ops/approx_topk_kernel.py); exact when off")
    recall_target: float = _f(0.95, "per-row recall target for --approx, in (0, 1]; 1 is the exact selection")
    compute_dtype: str = _f("float32", "compute dtype: float32|bfloat16")


@dataclass
class GanConfig(Config):
    """Flags of train.lua:15-49 plus the JAX package's additions, with its
    defaults. --prng is accepted and inert (both values mean torch's
    generators)."""
    save: str = _f("logs", "subdirectory to save logs")
    saveFreq: int = _f(30, "save every saveFreq epochs")
    epochs: int = _f(-1, "stop after that many epochs (<0 = run forever; the reference's inverted check, train.lua:208, is fixed as in the JAX package)")
    network: str = _f("", "checkpoint of a previous run to continue ('latest' = <save>/adversarial if it exists)")
    G_pretrained_dir: str = _f("logs", "directory with pretrained networks")
    nopretraining: bool = _f(False, "deactivate loading of pretrained networks")
    noplot: bool = _f(False, "disable plots/artifacts while training")
    D_sgd_lr: float = _f(0.02, "D SGD learning rate")
    G_sgd_lr: float = _f(0.02, "G SGD learning rate")
    D_sgd_momentum: float = _f(0.0, "D SGD momentum")
    G_sgd_momentum: float = _f(0.0, "G SGD momentum")
    batchSize: int = _f(32, "batch size")
    N_epoch: int = _f(30, "number of batches per epoch")
    G_L1: float = _f(0.0, "L1 penalty on the weights of G")
    G_L2: float = _f(0.0, "L2 penalty on the weights of G")
    D_L1: float = _f(0.0, "L1 penalty on the weights of D")
    D_L2: float = _f(1e-4, "L2 penalty on the weights of D")
    D_iterations: int = _f(1, "iterations to optimize D for, per batch")
    G_iterations: int = _f(1, "iterations to optimize G for, per batch")
    D_clamp: float = _f(1.0, "clamp D gradients to +/- this")
    G_clamp: float = _f(5.0, "clamp G gradients to +/- this")
    D_optmethod: str = _f("adam", "sgd|adagrad|adadelta|adamax|adam|rmsprop")
    G_optmethod: str = _f("adam", "sgd|adagrad|adadelta|adamax|adam|rmsprop")
    noiseDim: int = _f(32, "dimensionality of the noise vector")
    noiseMethod: str = _f("normal", "normal|uniform")
    seed: int = _f(1, "RNG seed")
    colorSpace: str = _f("rgb", "rgb|yuv|hsl|y")
    height: int = _f(32, "height of the training images")
    width: int = _f(32, "width of the training images")
    dataset: str = _f("NONE", "directory with *.jpg images, or 'synthetic'")
    exact_decode: bool = _f(False, "full-size exact JPEG decode (parity audits); default is DCT-scaled draft decode (data/dataset.py)")
    decode_cache: str = _f("", "directory for the decoded-tensor disk cache (data/cache.py), uint8-quantized; parity audits leave it off")
    normalize: bool = _f(False, "normalize training data to [-1,1] (train.lua:51,217-218); mean/std travel in the checkpoint")
    init: str = _f("heuristic", "weight init: heuristic (clean default) | torch (reproduce the reference's accidental initial distributions, models/zoo.py) | xavier | xavier_caffe | kaiming")
    mesh_data: int = _f(1, "data-parallel mesh axis size (0 = all devices, 1 = single-device)")
    mesh_model: int = _f(1, "tensor-parallel mesh axis size")
    compute_dtype: str = _f("float32", "compute dtype: float32|bfloat16")
    profile_dir: str = _f("", "write a torch.profiler Chrome trace of epoch 2 here (io/metrics.py::profiler_trace)")
    prng: str = _f("threefry", "accepted for the JAX CLI's sake: threefry|rbg; the port draws from torch generators either way")
    async_save: bool = _f(False, "overlap checkpoint file IO with the next epoch's device work (device snapshot stays synchronous; errors surface at the next save)")
    keep_history: int = _f(0, "also keep the newest N epoch-stamped checkpoints (adversarial.step<E>); 0 = only latest + .old")
    coordinator_address: str = _f("", "multi-process: host:port of process 0 (torch.distributed); empty = single-process")
    num_processes: int = _f(0, "multi-process: total process count")
    process_id: int = _f(-1, "multi-process: this process's index")


@dataclass
class SampleConfig(Config):
    """Flags of sample.lua:9-24 plus the JAX package's additions."""
    save: str = _f("logs", "directory with checkpoints")
    network: str = _f("logs/adversarial", "G+D checkpoint")
    writeto: str = _f("samples", "output directory")
    batchSize: int = _f(32, "inference batch size")
    neighbours: bool = _f(False, "find nearest training-set neighbours of best samples")
    neighbours_max: int = _f(0, "cap on training images scanned by --neighbours (0 = full trainset, like sample.lua:133's loadImages(0, 9999999))")
    runs: int = _f(1, "how often to sample and save images (sample.lua:17); run>1 artifacts get a _NNNN suffix")
    dataset: str = _f("NONE", "directory with *.jpg images, or 'synthetic'")
    exact_decode: bool = _f(False, "full-size exact JPEG decode (parity audits); default is DCT-scaled draft decode (data/dataset.py)")
    decode_cache: str = _f("", "directory for the decoded-tensor disk cache (data/cache.py), uint8-quantized; parity audits leave it off")
    seed: int = _f(1, "RNG seed")
    colorSpace: str = _f("rgb", "warned-on when it mismatches the checkpoint (sample.lua:210-217); the checkpoint wins")
    height: int = _f(32, "warned-on when it mismatches the checkpoint")
    width: int = _f(32, "warned-on when it mismatches the checkpoint")
    compute_dtype: str = _f("float32", "compute dtype")


@dataclass
class RConfig(Config):
    """Flags of train_r.lua:12-29 plus the JAX package's additions, with
    its defaults. --prng is accepted and inert (both values mean torch's
    generators)."""
    save: str = _f("logs", "subdirectory to save logs")
    batchSize: int = _f(32, "batch size")
    nbBatches: int = _f(-1, "max number of batches, <0 is infinite")
    noplot: bool = _f(False, "disable plots/artifacts")
    seed: int = _f(1, "RNG seed")
    saveFreq: int = _f(2000, "save every saveFreq batches")
    R_clamp: float = _f(1.0, "clamp R gradients to +/- this")
    R_L1: float = _f(0.0, "L1 penalty on the weights of R")
    R_L2: float = _f(1e-4, "L2 penalty on the weights of R")
    G: str = _f("logs/adversarial", "checkpoint of the trained G")
    cont: str = _f("", "R checkpoint to continue from (--continue upstream)")
    dataset: str = _f("NONE", "directory with *.jpg images (configured but unused for batches; R trains on (G(z), z) pairs, train_r.lua:138-139)")
    fixer: bool = _f(False, "train the error fixer (always-on input dropout)")
    prng: str = _f("rbg", "accepted for the JAX CLI's sake: threefry|rbg; the port draws from torch generators either way")
    dropout: str = _f("threefry", "mask source of R's dropouts: threefry (plain Bernoulli masks from a torch generator) | kernel (kernel B5, in-pass counter-hash masks, csrc/dropout.cu)")
    async_save: bool = _f(False, "overlap checkpoint file IO with the next segment's device work (device snapshot stays synchronous; errors surface at the next save)")
    # inherited from the G checkpoint at load time (train_r.lua:71-75):
    noiseDim: int = _f(32, "")
    noiseMethod: str = _f("normal", "")
    colorSpace: str = _f("rgb", "")
    height: int = _f(32, "")
    width: int = _f(32, "")
    mesh_data: int = _f(1, "data-parallel mesh axis size (0 = all devices, 1 = single-device)")
    mesh_model: int = _f(1, "tensor-parallel mesh axis size")
    compute_dtype: str = _f("float32", "compute dtype: float32|bfloat16")
    coordinator_address: str = _f("", "multi-process: host:port of process 0 (torch.distributed); empty = single-process")
    num_processes: int = _f(0, "multi-process: total process count")
    process_id: int = _f(-1, "multi-process: this process's index")


@dataclass
class PretrainGConfig(Config):
    """Flags of pretrain_g.lua:12-35 as the JAX package has them (defaults
    identical)."""
    save: str = _f("logs", "subdirectory to save logs")
    saveFreq: int = _f(30, "save every saveFreq epochs")
    epochs: int = _f(-1, "stop after that many epochs (<0 = run forever; the reference's inverted check fixed, pretrain_g.lua:112)")
    network: str = _f("", "reload a pretrained network (its decoder and loss history; the encoder starts fresh)")
    noplot: bool = _f(False, "disable plots/artifacts")
    batchSize: int = _f(128, "batch size")
    N_epoch: int = _f(30, "batches per epoch")
    G_L1: float = _f(0.0, "L1 penalty on the weights of G")
    G_L2: float = _f(0.0, "L2 penalty on the weights of G")
    G_clamp: float = _f(5.0, "clamp G gradients to +/- this")
    G_optmethod: str = _f("adam", "adam|adagrad")
    noiseDim: int = _f(100, "dimensionality of the bottleneck z")
    noiseMethod: str = _f("normal", "normal|uniform")
    seed: int = _f(1, "RNG seed")
    colorSpace: str = _f("rgb", "rgb|yuv|hsl|y")
    height: int = _f(32, "image height")
    width: int = _f(32, "image width")
    dataset: str = _f("NONE", "directory with *.jpg images, or 'synthetic'")
    exact_decode: bool = _f(False, "full-size exact JPEG decode (parity audits); default is DCT-scaled draft decode (data/dataset.py)")
    decode_cache: str = _f("", "directory for the decoded-tensor disk cache (data/cache.py), uint8-quantized; parity audits leave it off")
    compute_dtype: str = _f("float32", "compute dtype")


@dataclass
class PretrainPrevConfig(Config):
    """Flags of pretrain_with_previous_net.lua:12-37 as the JAX package has
    them (defaults identical)."""
    save: str = _f("logs", "subdirectory to save logs")
    batchSize: int = _f(32, "batch size")
    noplot: bool = _f(False, "disable plots/artifacts")
    seed: int = _f(1, "RNG seed")
    saveFreq: int = _f(50, "save every saveFreq batches")
    colorSpace: str = _f("rgb", "new color space")
    height: int = _f(32, "new image height")
    width: int = _f(32, "new image width")
    G_clamp: float = _f(5.0, "clamp G gradients to +/- this")
    D_clamp: float = _f(1.0, "clamp D gradients to +/- this")
    G_L1: float = _f(0.0, "L1 penalty on the weights of G")
    G_L2: float = _f(0.0, "L2 penalty on the weights of G")
    D_L1: float = _f(0.0, "L1 penalty on the weights of D")
    D_L2: float = _f(1e-4, "L2 penalty on the weights of D")
    noiseDim: int = _f(100, "new noise dimensionality")
    noiseMethod: str = _f("normal", "normal|uniform")
    network: str = _f("logs/adversarial", "previous G+D checkpoint to distill from")
    N_batches: int = _f(1000, "number of distillation batches")
    dataset: str = _f("NONE", "directory with *.jpg images, or 'synthetic'")
    exact_decode: bool = _f(False, "full-size exact JPEG decode (parity audits); default is DCT-scaled draft decode (data/dataset.py)")
    decode_cache: str = _f("", "directory for the decoded-tensor disk cache (data/cache.py), uint8-quantized; parity audits leave it off")
    compute_dtype: str = _f("float32", "compute dtype")
