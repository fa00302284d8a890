"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into an object
file, all of them at once in parallel processes, and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, not at import, keyed by a hash of the
sources and flags, into ``build/kernels/`` at the root of the checkout; a
missing ``nvcc`` raises there, on the first CUDA call, and never breaks
importing the package.

Each C entry point launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.

Each wrapper counts the launches of its kernel on its ``launches``
attribute, registered by :func:`counted`. A CUDA graph runs the wrapper's
Python once, at capture, and the kernel at every replay, so a captured
program adds its launches per replay with :func:`add_launches`
(``analysis/graphs.py``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {"none": 0, "relu": 1, "elu": 2, "sigmoid": 3, "prelu": 4,
             "tanh": 5}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
# name -> argtypes; every function returns the cudaError_t of its launch
_SIGNATURES = {
    # dtype, x, y, seed, n, base, thresh, inv_keep, stream
    "gr_fused_dropout": [_I, _P, _P, _P, _L, _U, _U, _F, _P],
    # dtype, x, w9, scale, shift, alpha, out, n, h, w, ci, co, act, pool,
    # then the bf16 plan (bh, bw, bn, bk, stages, smem), stream
    "gr_conv3x3_bn_act": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, *[_I] * 6, _P],
    # dtype, x, k16, scale, shift, out, n, h, w, ci, co, act, then the bf16
    # plan (bh, bw, bn, bk, stages, smem), stream
    "gr_upsample2_conv3x3_bn_act": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, *[_I] * 6, _P],
    # dtype, needles, emb, idx, ws, out, q, n, d, then the bf16 plan (bnq,
    # slices, stages, smem), stream
    "gr_cosine_scores": [_I, _P, _P, _P, _P, _P, _I, _I, _I, *[_I] * 4, _P],
    # x, c, c_new, counts, sums, assign, ws_f, ws_i, n, d, k, iters, then
    # the plan (rows, kt, smem_bytes, grid, tiles_per_block, max_segments),
    # stream
    "gr_kmeans_lloyd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        *[_I] * 6, _P],
    # smem_bytes -> co-resident blocks of the Lloyd kernel
    "gr_kmeans_resident": [_I],
    # dtype, x, k16, scale, shift, fk, fb, ws, out, n, h, w, ci, co, cf,
    # act, final_act, then the bf16 plan (bh, bw, bn, bk, stages, smem),
    # stream
    "gr_upsample2_conv3x3_head": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, *[_I] * 6, _P],
    # dtype, x, w9, y, ws, sum, sumsq, n, h, w, ci, co, then the bf16 plan
    # (bh, bw, bn, bk, stages, smem), stream
    "gr_conv_stats": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      *[_I] * 6, _P],
    # dtype, x, k4, scale, shift, out, n, h, w, ci, co, then the bf16 plan
    # (bh, bw, bn, bk, stages, smem), stream
    "gr_upsample_v2": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       *[_I] * 6, _P],
    # x, y, n, stream
    "gr_probe_add_one": [_P, _P, _L, _P],
    # x, y, g, per, stream
    "gr_probe_times_two": [_P, _P, _I, _L, _P],
    # a, b, c, m, n, k, stream
    "gr_probe_dot_bf16": [_P, _P, _P, _I, _I, _I, _P],
    # x, q, scale, parts, n, stream
    "gr_quantize_act": [_P, _P, _P, _P, _L, _P],
    # x, amax, q, scale, n, stream
    "gr_quantize_act_max": [_P, _P, _P, _P, _L, _P],
    # x, w, x_scale, w_scale, bias, out, amax, n, h, w, ci, co, act, pool,
    # then the int8 plan (bh, bw, bn, bk, stages, smem), stream
    "gr_quant_conv3x3": [*[_P] * 7, *[_I] * 7, *[_I] * 6, _P],
    # x, w, x_scale, w_scale, shift, out, amax, n, h, w, ci, co, act, then
    # the int8 plan (bh, bw, bn, bk, stages, smem), stream
    "gr_quant_upsample2_conv3x3": [*[_P] * 7, *[_I] * 6, *[_I] * 6, _P],
    # x, w, x_scale, w_scale, bias, out, part, amax, n, k, m, act, splits,
    # then the plan (bh, bw, bn, bk, stages, smem), stream
    "gr_quant_dense": [*[_P] * 8, *[_I] * 5, *[_I] * 6, _P],
    # scores, values, indices, q, n, k, then the plan (bins, cluster,
    # keys_on_chip, sort_on_chip, stage_row), stream
    "gr_approx_topk": [*[_P] * 3, *[_I] * 8, _P],
    # x, w, shift, out, part, n, k, m, act, splits, then the plan (bh, bw,
    # bn, bk, stages, smem), stream
    "gr_dense_bf16": [*[_P] * 5, *[_I] * 5, *[_I] * 6, _P],
    # in dtype, out dtype, x, y, n, hi, wi, ho, wo, c, up, down, pad0,
    # round_in, round_out, then the plan (vec, rows), stream
    "gr_fir_filter": [_I, _I, _P, _P, *[_I] * 13, _P],
}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): PATH, then
    $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", name)
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        f"{name} not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "ganreverser_tpu_torch/csrc cannot be built or inspected")


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/kernels/libgr_kernels_<hash>.so``
    unless that file exists; returns its path. One ``nvcc -c`` per source,
    all started together, then one link. The compilers' output, ``-Xptxas
    -v`` included, is kept beside the library as ``build_<hash>.log``."""
    tag = source_hash()
    lib = BUILD_DIR / f"libgr_kernels_{tag}.so"
    if lib.is_file():
        return lib
    nvcc = cuda_tool("nvcc")
    work = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
               str(work / f"{src.stem}.o")]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n# rc {proc.returncode}\n{out}")
        if proc.returncode != 0:
            failed.append(out)
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in sorted(work.glob("*.o")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n# rc {proc.returncode}\n"
                    f"{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(proc.stderr)
    log = BUILD_DIR / f"build_{tag}.log"
    log.write_text(f"# {time.perf_counter() - t0:.1f} s\n" + "\n".join(logs))
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError(f"nvcc failed; see {log}:\n"
                           f"{failed[0][-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError "
                           f"{rc}")


# the current stream's handle without building a torch.cuda.Stream object
# (about 0.1 us against 4 us a call on the card's host)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


# every wrapper with a ``launches`` count, in registration order
COUNTED: list = []


def counted(fn):
    """Register ``fn`` as a wrapper whose ``launches`` counts its kernel's
    launches, starting at 0; returns ``fn``."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def launch_counts() -> list:
    """The ``launches`` of every registered wrapper, in :data:`COUNTED`'s
    order."""
    return [fn.launches for fn in COUNTED]


def add_launches(deltas) -> None:
    """Add ``deltas`` (one per registered wrapper, as
    :func:`launch_counts` orders them) to the wrappers' counts."""
    for fn, d in zip(COUNTED, deltas):
        fn.launches += d


def on_device(t: torch.Tensor):
    """A context with ``t``'s device current: nothing to do where it is
    already (the common case, which saves the switch on every launch)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require(t: torch.Tensor, name: str, device: torch.device, dtype,
            shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what a kernel argument must be)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dispatch_device(*tensors: torch.Tensor) -> str:
    """'cpu' (take the plain version) or 'cuda' (launch the kernel); raises
    for mixed devices and for any other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device type {kind!r}")
    return kind
