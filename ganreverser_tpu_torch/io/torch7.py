"""Torch7 ``torch.save`` binary reader — import the reference's checkpoints
(the port's own copy of ganreverser_tpu/io/torch7.py, numpy and ``struct``
only, same behaviour).

The reference persists everything with Torch7's native serializer
(/root/reference/train.lua:256, train_r.lua:234, pretrain_g.lua:202,
pretrain_with_previous_net.lua:265): ``torch.save(filename, {...})`` in
binary mode. A user switching from the reference has ``*.net`` files in
exactly this format; this module reads them into plain Python objects so
``io/import_t7.py`` can map the weights into this framework's checkpoints.

Format (torch7 ``File:writeObject``, little-endian):

  object   := int32 type-tag, payload
  tag 0    nil       (no payload)
  tag 1    number    (float64)
  tag 2    string    (int32 size, bytes)
  tag 5    boolean   (int32 0/1)
  tag 3    table     (int32 memo-index; if new: int32 npairs, npairs x
                      (key object, value object))
  tag 4    torch obj (int32 memo-index; if new: version string record
                      'V <n>' — or, pre-versioning, the class name itself —
                      then class name string record, then the payload:
                      a custom tensor/storage record for torch.*Tensor /
                      torch.*Storage, else one table object)
  tag 6/7/8 function  (serialized Lua bytecode — read+skipped; nn graphs
                      from the reference contain none)

  tensor   := int32 ndim, int64 sizes[ndim], int64 strides[ndim],
              int64 storageOffset (1-based), object (its storage, or nil —
              the reference's save-prep zeroes activation buffers via
              ``tensor:resize()``, nn_utils.lua:383-415, leaving ndim=0)
  storage  := int64 size, size x element (width per dtype)

Memoization: tables and torch objects are written once and back-referenced
by index on repeat (shared storages, recursive module graphs) — the reader
keeps the same registry, inserting placeholders before recursing so cycles
resolve.

CUDA types (the reference saves trained nets WITHOUT converting to float
— prepareNetworkForSave only zeroes temporaries) serialize their data as
4-byte floats, so torch.Cuda{Tensor,Storage} read as their Float peers.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Optional

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_LEGACY_RECUR_FUNCTION = 7
TYPE_RECUR_FUNCTION = 8

# element dtype per storage class; Cuda variants store plain floats
_STORAGE_DTYPES = {
    "torch.DoubleStorage": np.dtype("<f8"),
    "torch.FloatStorage": np.dtype("<f4"),
    "torch.HalfStorage": np.dtype("<f2"),
    "torch.LongStorage": np.dtype("<i8"),
    "torch.IntStorage": np.dtype("<i4"),
    "torch.ShortStorage": np.dtype("<i2"),
    "torch.CharStorage": np.dtype("<i1"),
    "torch.ByteStorage": np.dtype("<u1"),
    "torch.CudaStorage": np.dtype("<f4"),
    "torch.CudaDoubleStorage": np.dtype("<f8"),
    "torch.CudaHalfStorage": np.dtype("<f2"),
    "torch.CudaLongStorage": np.dtype("<i8"),
    "torch.CudaIntStorage": np.dtype("<i4"),
    "torch.CudaByteStorage": np.dtype("<u1"),
}
_TENSOR_CLASSES = {
    c.replace("Storage", "Tensor"): d for c, d in _STORAGE_DTYPES.items()
}


@dataclass
class TorchObject:
    """A deserialized torch class instance: ``nn.Linear``, ``nn.Sequential``
    etc. ``payload`` is the instance table (string/number keyed dict)."""
    torch_class: str
    payload: dict = field(default_factory=dict)

    def __getitem__(self, key):
        return self.payload[key]

    def get(self, key, default=None):
        return self.payload.get(key, default)

    def __contains__(self, key):
        return key in self.payload

    def __repr__(self):  # keep module dumps readable
        keys = list(self.payload)[:6]
        return f"TorchObject({self.torch_class}, keys={keys})"


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: dict[int, Any] = {}

    # -- primitives ---------------------------------------------------------
    def _read(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise EOFError(f"truncated t7 file (wanted {n} bytes, got "
                           f"{len(b)})")
        return b

    def int32(self) -> int:
        return struct.unpack("<i", self._read(4))[0]

    def int64(self) -> int:
        return struct.unpack("<q", self._read(8))[0]

    def float64(self) -> float:
        return struct.unpack("<d", self._read(8))[0]

    def string(self) -> str:
        n = self.int32()
        return self._read(n).decode("latin-1")

    # -- records ------------------------------------------------------------
    def read_object(self) -> Any:
        tag = self.int32()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            v = self.float64()
            return int(v) if v.is_integer() and abs(v) < 2**53 else v
        if tag == TYPE_STRING:
            return self.string()
        if tag == TYPE_BOOLEAN:
            return self.int32() == 1
        if tag == TYPE_TABLE:
            return self._read_table()
        if tag == TYPE_TORCH:
            return self._read_torch()
        if tag in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                   TYPE_LEGACY_RECUR_FUNCTION):
            return self._read_function(tag)
        raise ValueError(f"unknown t7 type tag {tag}")

    def _read_table(self) -> dict:
        index = self.int32()
        if index in self.memo:
            return self.memo[index]
        out: dict = {}
        self.memo[index] = out  # placeholder first: tables can be cyclic
        n = self.int32()
        for _ in range(n):
            k = self.read_object()
            v = self.read_object()
            out[k] = v
        return out

    def _read_function(self, tag: int) -> None:
        """Lua function dumps (closures in saved graphs) — size-prefixed
        bytecode plus an upvalue table; unusable from Python, read+drop."""
        if tag in (TYPE_RECUR_FUNCTION, TYPE_LEGACY_RECUR_FUNCTION):
            index = self.int32()
            if index in self.memo:
                return self.memo[index]
            self.memo[index] = None
        size = self.int32()
        self._read(size)
        self.read_object()  # upvalues table
        return None

    def _read_torch(self) -> Any:
        index = self.int32()
        if index in self.memo:
            return self.memo[index]
        version = self.string()
        if version.startswith("V "):
            class_name = self.string()
        else:  # pre-versioning files: that string WAS the class name
            class_name = version

        if class_name in _TENSOR_CLASSES:
            arr = self._read_tensor(_TENSOR_CLASSES[class_name])
            self.memo[index] = arr
            return arr
        if class_name in _STORAGE_DTYPES:
            arr = self._read_storage(_STORAGE_DTYPES[class_name])
            self.memo[index] = arr
            return arr

        obj = TorchObject(class_name)
        self.memo[index] = obj  # placeholder first: modules self-reference
        payload = self.read_object()
        if isinstance(payload, dict):
            obj.payload = payload
        return obj

    def _read_tensor(self, dtype: np.dtype) -> np.ndarray:
        ndim = self.int32()
        sizes = [self.int64() for _ in range(ndim)]
        strides = [self.int64() for _ in range(ndim)]
        offset = self.int64() - 1  # torch storageOffset is 1-based
        storage = self.read_object()
        if ndim == 0 or storage is None or storage.size == 0:
            return np.zeros(sizes, dtype=dtype)
        # strided view into the flat storage, then a compact copy
        view = np.lib.stride_tricks.as_strided(
            storage[offset:],
            shape=sizes,
            strides=[s * storage.dtype.itemsize for s in strides])
        return np.array(view, dtype=dtype)

    def _read_storage(self, dtype: np.dtype) -> np.ndarray:
        n = self.int64()
        return np.frombuffer(self._read(n * dtype.itemsize),
                             dtype=dtype).copy()


def load(path: str) -> Any:
    """Read one serialized object (the reference always saves exactly one
    top-level table) from a binary-mode torch.save file."""
    with open(path, "rb") as f:
        return _Reader(f).read_object()


def table_to_list(t: Optional[dict]) -> list:
    """A Lua array-table ({1:…, 2:…, …}) as a Python list. Non-contiguous
    or non-numeric keys raise — callers pass known array tables only."""
    if t is None:
        return []
    if isinstance(t, list):
        return t
    out = []
    for i in range(1, len(t) + 1):
        if i not in t:
            raise ValueError(f"table is not a 1..{len(t)} array "
                             f"(missing key {i})")
        out.append(t[i])
    return out
