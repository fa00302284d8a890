"""Serving artifacts: weights-baked ``torch.export`` programs over the
port's kernels, the counterpart of ganreverser_tpu/io/serving.py.

A program is traced once, at release time, with its weights baked in as
constants, and saved with ``torch.export.save``; a serving process loads it
with ``torch.export.load`` and runs it with no model code, checkpoint or
config: only this module, the kernels' custom operators
(``ops/library.py``, which the trace recorded as single calls) and the
CUDA-graph helper (``analysis/graphs.py``). Shapes are static, as JAX's
exported programs' are: batch (and N for e2e) are fixed at export time.

Artifact layout, the JAX package's: ``<dir>/manifest.json`` (what the
program is: kind, geometry, batch, dtype, platforms, format, framework
version) and ``<dir>/program.pt2``. An int8 program (``"int8": true``)
bakes the int8 kernels' weight operands in, so its manifest also records
their layout (``int8_operands``, ``ops/quant.py::OPERAND_LAYOUT``), and the
loader refuses an int8 artifact of another layout or none. The platforms
are device types of PyTorch, ``cuda`` and ``cpu`` (the JAX package's are
``tpu`` and ``cpu``): one artifact runs on the card and on a CPU host,
where each kernel's operator takes its plain version.

Build, check, load (``cli/export.py``):

    python -m ganreverser_tpu_torch.cli.export --G logs/adversarial \\
        --save logs --out logs/serve_invert --what invert --batch 256 \\
        --compute_dtype bfloat16 --check
    call, meta = load_serving_program("logs/serve_invert")
    z_hat = call(images)          # (batch, noiseDim)

On the card the loaded program runs as one CUDA graph
(``analysis/graphs.py::CapturedProgram``, captured at its first call), the
analogue of ``jax.jit(exp.call)``.
"""
from __future__ import annotations

import io
import json
import os
from typing import Any, Callable

import torch
import torch.export.passes
from torch import nn

from ..analysis.graphs import CapturedProgram
from ..core.platform import resolve_device
from ..ops import library  # noqa: F401  (registers the kernels' operators)
from ..ops import quant

MANIFEST = "manifest.json"
PROGRAM = "program.pt2"
FORMAT = "torch.export/pt2"
PLATFORMS = ("cuda", "cpu")
INT8_OPERANDS = "int8_operands"   # the manifest key of the int8 layout


class _Closure(nn.Module):
    """``fn`` as a module to trace: the tensors it closes over become the
    exported program's constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def check_platforms(platforms) -> tuple:
    """``platforms`` as a tuple; raises ValueError unless each is one of
    PLATFORMS."""
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"the port's artifacts run on {', '.join(PLATFORMS)}"
                         f", not {list(platforms)}; a TPU artifact is the "
                         "JAX package's export")
    return platforms


def export_serving_program(fn: Callable, example_args: tuple,
                           platforms=PLATFORMS) -> bytes:
    """Trace ``fn`` at ``example_args``' static shapes
    (``torch.export.export``, not strict) and serialize the result. Weights
    must be closed over: they are baked into the artifact as constants.
    ``platforms`` is checked here and recorded by
    :func:`save_serving_program`; one trace serves all of them, the loader
    moving the program to its device."""
    check_platforms(platforms)
    with torch.no_grad():
        ep = torch.export.export(_Closure(fn), tuple(example_args),
                                 strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_serving_program(path: str, fn: Callable, example_args: tuple,
                         meta: dict[str, Any],
                         platforms=PLATFORMS) -> None:
    """Export ``fn`` and write the artifact directory (manifest + program).

    ``meta`` documents the program for the loader and a reader (kind,
    geometry, batch, dtype...); ``platforms``, the format and PyTorch's
    version are recorded beside it."""
    platforms = check_platforms(platforms)
    data = export_serving_program(fn, example_args, platforms)
    os.makedirs(path, exist_ok=True)
    manifest = dict(meta)
    manifest["platforms"] = list(platforms)
    manifest["format"] = FORMAT
    manifest["torch_version"] = torch.__version__
    if manifest.get("int8"):
        manifest[INT8_OPERANDS] = quant.OPERAND_LAYOUT
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    with open(os.path.join(path, PROGRAM), "wb") as f:
        f.write(data)


def load_serving_program(path: str, device: torch.device | str | None = None):
    """Returns ``(call, meta)``: ``call`` runs the loaded program on
    ``device`` (default: the card, or the CPU where GANREVERSER_PLATFORM
    asks for it), its inputs moved there; on the card it is one CUDA graph
    captured at the first call. ``meta`` is the manifest. Raises if the
    device's type is not in the artifact's platforms, and for an int8
    artifact whose weight operands are not in the kernels' layout."""
    with open(os.path.join(path, MANIFEST)) as f:
        meta = json.load(f)
    if meta.get("int8") and meta.get(INT8_OPERANDS) != quant.OPERAND_LAYOUT:
        raise RuntimeError(
            f"{path}: an int8 artifact whose baked weight operands are laid "
            f"out as {meta.get(INT8_OPERANDS) or 'words of four channels'}, "
            f"not as the int8 kernels read them ({quant.OPERAND_LAYOUT}); "
            "export it again with this version (cli/export.py --int8)")
    dev = resolve_device() if device is None else torch.device(device)
    if dev.type not in meta["platforms"]:
        raise RuntimeError(f"{path}: exported for platforms "
                           f"{meta['platforms']}, not for {dev.type}")
    ep = torch.export.load(os.path.join(path, PROGRAM))
    ep = torch.export.passes.move_to_device_pass(ep, str(dev))
    program = CapturedProgram(ep.module())

    def call(*args):
        return program(*(torch.as_tensor(a).to(dev) for a in args))

    return call, meta
