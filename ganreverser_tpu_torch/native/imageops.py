"""ctypes bindings of the host image ops (imageops.cc) — the counterpart
of ganreverser_tpu/native/imageops.py, with its functions and C
signatures.

The shared library is built with the system ``g++`` at first use, into
``build/native/`` at the root of the checkout (keyed by a hash of the
source), never beside the source. Host code, not a device kernel: where
no compiler is found or the build fails, every entry point returns None
(or False) and its caller takes the numpy path, as in the JAX package.
``available()`` says which path is active.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "imageops.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_f32p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "resize_bilinear_batch": [_f32p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, _f32p,
                              ctypes.c_int, ctypes.c_int],
    "rgb2y": [_f32p, ctypes.c_long, _f32p],
    "rgb2yuv": [_f32p, ctypes.c_long, _f32p],
    "yuv2rgb": [_f32p, ctypes.c_long, _f32p],
    "normalize_pm1": [_f32p, ctypes.c_long],
    "assemble_grid": [_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, _f32p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int],
}


class _Library:
    """The loaded library, built on the first call of :meth:`get`; None
    when it cannot be built (the reason in ``failure``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.tried = False
        self.failure = ""

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
        return BUILD_DIR / f"libimageops_{h.hexdigest()[:16]}.so"

    def build(self) -> Optional[Path]:
        lib = self.path()
        if lib.is_file():
            return lib
        cxx = shutil.which("g++")
        if cxx is None:
            self.failure = "g++ not found"
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            self.failure = f"g++ failed: {e}"
            return None
        os.replace(tmp, lib)  # atomic: ranks building at once all agree
        return lib

    def get(self) -> Optional[ctypes.CDLL]:
        with self.lock:
            if self.tried:
                return self.lib
            self.tried = True
            path = self.build()
            if path is None:
                return None
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                self.failure = f"load failed: {e}"
                return None
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            self.lib = lib
            return lib


_LIBRARY = _Library()


def available() -> bool:
    return _LIBRARY.get() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _c32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def resize_bilinear_batch(images: np.ndarray, dh: int,
                          dw: int) -> Optional[np.ndarray]:
    """(n, sh, sw, c) float32 -> (n, dh, dw, c), bilinear with half-pixel
    centres; None without the library."""
    lib = _LIBRARY.get()
    if lib is None:
        return None
    images = _c32(images)
    n, sh, sw, c = images.shape
    out = np.empty((n, dh, dw, c), np.float32)
    lib.resize_bilinear_batch(_ptr(images), n, sh, sw, c, _ptr(out), dh, dw)
    return out


def _pixelwise(name: str, images: np.ndarray,
               out_channels: int) -> Optional[np.ndarray]:
    lib = _LIBRARY.get()
    if lib is None:
        return None
    images = _c32(images)
    out = np.empty(images.shape[:-1] + (out_channels,), np.float32)
    getattr(lib, name)(_ptr(images), images.size // 3, _ptr(out))
    return out


def rgb2y_native(images: np.ndarray) -> Optional[np.ndarray]:
    return _pixelwise("rgb2y", images, 1)


def rgb2yuv_native(images: np.ndarray) -> Optional[np.ndarray]:
    return _pixelwise("rgb2yuv", images, 3)


def yuv2rgb_native(images: np.ndarray) -> Optional[np.ndarray]:
    return _pixelwise("yuv2rgb", images, 3)


def normalize_pm1_inplace(images: np.ndarray) -> bool:
    """In-place [0,1]->[-1,1]+clamp; returns False if numpy fallback needed."""
    lib = _LIBRARY.get()
    if lib is None or images.dtype != np.float32 or \
            not images.flags.c_contiguous:
        return False
    lib.normalize_pm1(_ptr(images), images.size)
    return True


def assemble_grid(images: np.ndarray, gh: int, gw: int,
                  strip: int = 0) -> Optional[np.ndarray]:
    """(n, ih, iw, c) tiled row by row into a zeroed (gh ih + strip, gw iw,
    c) canvas; None without the library."""
    lib = _LIBRARY.get()
    if lib is None:
        return None
    images = _c32(images)
    n, ih, iw, c = images.shape
    out = np.empty((gh * ih + strip, gw * iw, c), np.float32)
    lib.assemble_grid(_ptr(images), n, ih, iw, c, _ptr(out), gh, gw, strip)
    return out
