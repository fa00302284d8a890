"""The kernels as ``torch.library`` custom operators, ``ganreverser::*``.

Each kernel wrapper that a fast forward or a search calls (``conv_block``,
``upsample2_conv3x3_bn_act``, its fused head, ``dense_act``,
``cosine_scores``, ``approx_topk`` and the int8 kernels Q1-Q4 of
``ops/quant.py``, Q4's one pass after a producer included) goes through
one operator here,
so that ``torch.export`` can trace a program over the kernels
(``io/serving.py``): the trace records one call of the operator, whose
output shape and dtype come from its fake implementation, and a loaded
program calls the operator again. The operator's body is the wrapper's
launch: the kernel on CUDA tensors, the plain version on CPU tensors, a
raise on anything else (``cuda_lib.dispatch_device``). The launch counts
stay in the bodies, so a trace (which runs the fake implementations)
counts no launch.

The operators are registered with ``torch.library.Library`` for the CPU
and CUDA dispatch keys: one dispatcher call on the host, lighter than
``torch.library.custom_op``'s Python layers, and nothing inside a CUDA
graph. None returns an alias of an input. Importing
``ganreverser_tpu_torch.ops`` registers them (``ops/__init__.py``); a
process that loads an exported program needs this module and the kernel
modules it imports, nothing under ``models/`` or ``cli/``.
"""
from __future__ import annotations

import torch

from . import (approx_topk_kernel, conv_block_kernel, dense_kernel, quant,
               topk_kernel, upsample_conv_kernel)

NAMESPACE = "ganreverser"

_LIB = torch.library.Library(NAMESPACE, "DEF")

# the registered operators' names
OPS: list = []


def _define(name: str, schema: str, body, fake) -> None:
    _LIB.define(f"{name}{schema}")
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, body, key)
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    OPS.append(name)


def _conv_block_fake(x, kernels, scales, shifts, act, pool, operands):
    n, h, w, _ = x.shape
    if pool:
        h, w = h // 2, w // 2
    return x.new_empty((n, h, w, kernels[-1].shape[-1]))


def _upsample_fake(x, kernel, scale, shift, act, operand):
    n, h, w, _ = x.shape
    return x.new_empty((n, 2 * h, 2 * w, kernel.shape[-1]))


def _head_fake(x, kernel, scale, shift, final_kernel, final_bias, act,
               final_act, operand, final_operand):
    n, h, w, _ = x.shape
    return x.new_empty((n, 2 * h, 2 * w, final_kernel.shape[-1]))


def _dense_fake(x, operand, shift, act):
    return x.new_empty((x.shape[0], operand.shape[0]), dtype=torch.bfloat16)


def _cosine_fake(embeddings, needle_idx):
    return embeddings.new_empty((needle_idx.shape[0], embeddings.shape[0]),
                                dtype=torch.float32)


def _approx_topk_fake(scores, k, recall_target):
    return (scores.new_empty((scores.shape[0], k), dtype=torch.float32),
            scores.new_empty((scores.shape[0], k), dtype=torch.int64))


def _quantize_fake(x):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((), dtype=torch.float32))


def _quantize_max_fake(x, amax):
    return _quantize_fake(x)


def _with_max_fake(y, with_max):
    """A producer's (y, max |y|): the max 0-d, or (0,) where not asked."""
    return y, y.new_empty(() if with_max else (0,))


def _quant_conv_fake(xq, x_scale, wq, w_scale, bias, act, pool, with_max,
                     operand):
    n, h, w, _ = xq.shape
    if pool:
        h, w = h // 2, w // 2
    return _with_max_fake(xq.new_empty((n, h, w, wq.shape[-1]),
                                       dtype=torch.float32), with_max)


def _quant_upsample_fake(xq, x_scale, wq16, w_scale, shift, act, with_max,
                         operand):
    n, h, w, _ = xq.shape
    return _with_max_fake(xq.new_empty((n, 2 * h, 2 * w, wq16.shape[-1]),
                                       dtype=torch.float32), with_max)


def _quant_dense_fake(xq, x_scale, wq, w_scale, bias, act, with_max,
                      operand):
    return _with_max_fake(xq.new_empty((xq.shape[0], wq.shape[-1]),
                                       dtype=torch.float32), with_max)


_define("conv_block",
        "(Tensor x, Tensor[] kernels, Tensor[] scales, Tensor[] shifts, "
        "str act, bool pool, Tensor[]? operands) -> Tensor",
        conv_block_kernel.launch_conv_block, _conv_block_fake)
_define("upsample2_conv3x3_bn_act",
        "(Tensor x, Tensor kernel, Tensor scale, Tensor shift, str act, "
        "Tensor? operand) -> Tensor",
        upsample_conv_kernel.launch_upsample2_conv3x3_bn_act, _upsample_fake)
_define("upsample2_conv3x3_head",
        "(Tensor x, Tensor kernel, Tensor scale, Tensor shift, "
        "Tensor final_kernel, Tensor final_bias, str act, str final_act, "
        "Tensor? operand, Tensor? final_operand) -> Tensor",
        upsample_conv_kernel.launch_upsample2_conv3x3_head, _head_fake)
_define("dense_act", "(Tensor x, Tensor operand, Tensor shift, str act) "
        "-> Tensor", dense_kernel.launch_dense_act, _dense_fake)
_define("cosine_scores", "(Tensor embeddings, Tensor needle_idx) -> Tensor",
        topk_kernel.launch_cosine_scores, _cosine_fake)
_define("approx_topk",
        "(Tensor scores, int k, float recall_target) -> (Tensor, Tensor)",
        approx_topk_kernel.launch_approx_topk, _approx_topk_fake)
_define("quantize_act", "(Tensor x) -> (Tensor, Tensor)",
        quant.launch_quantize_act, _quantize_fake)
_define("quantize_act_max", "(Tensor x, Tensor amax) -> (Tensor, Tensor)",
        quant.launch_quantize_act_max, _quantize_max_fake)
# the int8 producers return (y, max |y|), the max empty without with_max
_define("quant_conv3x3",
        "(Tensor xq, Tensor x_scale, Tensor wq, Tensor w_scale, Tensor bias, "
        "str act, bool pool, bool with_max, Tensor? operand) "
        "-> (Tensor, Tensor)",
        quant.launch_quant_conv3x3, _quant_conv_fake)
_define("quant_upsample2_conv3x3",
        "(Tensor xq, Tensor x_scale, Tensor wq16, Tensor w_scale, "
        "Tensor shift, str act, bool with_max, Tensor? operand) "
        "-> (Tensor, Tensor)",
        quant.launch_quant_upsample2_conv3x3, _quant_upsample_fake)
_define("quant_dense",
        "(Tensor xq, Tensor x_scale, Tensor wq, Tensor w_scale, Tensor bias, "
        "str act, bool with_max, Tensor? operand) -> (Tensor, Tensor)",
        quant.launch_quant_dense, _quant_dense_fake)
