"""A program run as one CUDA graph: the port's counterpart of a jitted JAX
program (analysis/e2e.py's fused and serial programs).

:class:`CapturedProgram` wraps ``fn`` (trees of tensors in, a tree of
tensors out). On CUDA tensors, its first call for a signature (the input
tree's structure, each leaf's shape, dtype and device) runs ``fn`` once
on a side stream to warm it up (the kernels' build and first launches,
cuBLAS's workspace), then captures one call into a ``torch.cuda.CUDAGraph``
on static copies of the inputs. Every call then copies its inputs into
those buffers, replays the graph and returns clones of its outputs, so
another call's weights or latents give their own result and a later call
does not overwrite what an earlier one returned. A capture that fails
raises: there is no eager fallback on the card. On CPU tensors, or with
``capture=False``, ``fn`` runs eagerly.

The kernel wrappers count their launches in Python (ops/cuda_lib.py),
which a replay does not run: the counts a capture added are taken back,
and added again at every replay, so each count stays the number of
launches the device ran (the warm-up's included).

A call on the graph path is the span ``gr.program.call``, holding
``gr.program.copy_in``, ``gr.program.replay`` and ``gr.program.clone_out``
(io/metrics.py::span; nothing inside the graph is a span).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..io.metrics import span
from ..ops import cuda_lib


class _Graph(NamedTuple):
    static: list         # the input leaves' buffers, in flatten order
    graph: object        # torch.cuda.CUDAGraph
    outputs: object      # the output tree, in the graph's pool
    launches: list       # per registered wrapper, its launches per replay


class CapturedProgram:
    """``fn`` as one CUDA graph per input signature (module docstring)."""

    def __init__(self, fn: Callable, *, capture: bool = True):
        self.fn = fn
        self.capture = capture
        self.graphs: dict = {}

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        on_card = any(isinstance(t, torch.Tensor) and t.is_cuda
                      for t in leaves)
        if not (on_card and self.capture):
            with torch.no_grad():
                return self.fn(*args)
        key = (repr(spec), tuple((tuple(t.shape), t.dtype, t.device)
                                 for t in leaves))
        # static buffers are ordinary tensors also when the caller is in
        # inference mode, so that a later call outside it may fill them
        with span("gr.program.call"), torch.inference_mode(False), \
                torch.no_grad(), cuda_lib.on_device(leaves[0]):
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = self._capture(leaves, spec)
            with span("gr.program.copy_in"):
                for buf, t in zip(entry.static, leaves):
                    buf.copy_(t)
            with span("gr.program.replay"):
                entry.graph.replay()
                cuda_lib.add_launches(entry.launches)
            with span("gr.program.clone_out"):
                return pytree.tree_map(torch.clone, entry.outputs)

    def _capture(self, leaves, spec) -> _Graph:
        static = [t.detach().clone() for t in leaves]
        args = pytree.tree_unflatten(static, spec)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        before = cuda_lib.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = self.fn(*args)
        launches = [a - b for a, b in zip(cuda_lib.launch_counts(), before)]
        cuda_lib.add_launches([-d for d in launches])  # nothing ran yet
        return _Graph(static, graph, outputs, launches)
