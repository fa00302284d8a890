"""The operands and tile plan of the tensor-core convolutions
(``csrc/conv_wgmma.cuh``: kernels B, B6, U, B7 and B8 in bf16, Q1 and Q2 in
int8), and plain versions of their implicit GEMM in the kernel's K order.

TMA reads rows that are a multiple of 16 bytes, so ``pad_channels`` zero-pads
an NHWC input's channels up to a multiple of 8, and a narrow stem's up to
the stage depth, 16 or 32 (``padded_channels``): zero channels add exact
zeros to the f32 sums, and TMA is slow on rows that lie half outside the
tensor. ``kmajor`` pads the weights' Ci to match: they go (taps, Co, Ci'),
each tap's (Co, Ci') slice K-major, as the activations' tile is, so the
tensor cores transpose neither operand. A 3x3 conv has the 9 taps of its
HWIO kernel (tap t is (t // 3, t % 3)); kernel U has the 16 phase taps
``[a, ta, b, tb]`` of ``phase_kernels``, four per output phase. Kernel B8
stacks each phase's four taps on K instead (``stacked_kmajor``): (4 phases,
Co, 4 * Kp), tap t at ``[t * Kp, t * Kp + Ci')``, Kp = Ci' rounded up to BK,
so one weight box never spans two taps.

The int8 kernels Q1 and Q2 (``ops/quant.py``) take the same layouts in int8,
``elem_bytes=1``: the same rows in bytes (32 or 64 bytes where the channels
are that narrow, else a multiple of 16), so 32 or 64 int8 channels, or a
multiple of 16, and BK up to 128 elements.

``tile_plan`` is the one place where a launch's tile is chosen: 128 output
pixels as a BH x BW patch of one image, BN output channels, BK input
channels per stage, the ring's stage count and the block's shared bytes;
``csrc/conv_wgmma.cuh`` checks a plan against its layout and refuses one
that does not fit. The epilogue stages the output tile through the ring, so
a plan for B7's f32 output (``out_bytes=4``) has a ring that holds twice the
bf16 tile.

U's fused head in bf16 runs U's tile with a second product in its
epilogue (``csrc/conv_wgmma.cuh``'s HeadTapsEpilogue): ``head_plan`` is
U's plan with BN at most 128 and the head's weight tile behind the ring,
``head_weights`` lays the (3,3,Co,Cf) head out K-major as (``head_rows``,
Co'), and ``head_workspace_shape`` is the shape of the tap partials the
first launch writes and the second adds up.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

BM = 128                     # output pixels per block (two warpgroups)
MAX_SHARED_BYTES = 232_448   # dynamic shared memory a block may use (sm_90)
ALIGN = 1024                 # a stage starts on the 128-byte swizzle's period
MAX_STAGES = 8
WIDTHS_N = (16, 32, 64, 128, 256)   # BN the kernel is built for
# bytes of the TMA ring by BN: three blocks per SM up to BN = 64, one above
RING_BYTES = {16: 72 << 10, 32: 72 << 10, 64: 72 << 10, 128: 128 << 10,
              256: 192 << 10}

# taps as (dy, dx, weight index)
CONV3X3_TAPS = tuple((t // 3 - 1, t % 3 - 1, t) for t in range(9))


def phase_taps(a: int, b: int) -> tuple:
    """The four taps of U's output phase (a, b): input offsets
    (a + ta - 1, b + tb - 1) with the phase kernel [a, ta, b, tb]."""
    return tuple((a + ta - 1, b + tb - 1, ((a * 2 + ta) * 2 + b) * 2 + tb)
                 for ta in (0, 1) for tb in (0, 1))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def padded_channels(ci: int, elem_bytes: int = 2) -> int:
    """Ci as the tensor-core tile reads it, in elements of ``elem_bytes``
    (2 bf16, 1 int8): rows of a multiple of 16 bytes, and of 32 or 64
    bytes where they are that narrow, so that the stage depth BK (rows of
    32, 64 or 128 bytes) never reaches past the tensor's channels: bf16 16,
    32 or a multiple of 8; int8 32, 64 or a multiple of 16."""
    cp = _round_up(ci, 16 // elem_bytes)
    narrow, wide = 32 // elem_bytes, 64 // elem_bytes
    return cp if cp > wide else (narrow if cp <= narrow else wide)


def pad_channels(x: torch.Tensor, elem_bytes: int = 2) -> torch.Tensor:
    """``x`` with its last dim zero-padded to ``padded_channels`` (``x``
    itself, contiguous, when it needs none)."""
    c = x.shape[-1]
    cp = padded_channels(c, elem_bytes)
    if cp == c:
        return x.contiguous()
    out = x.new_zeros((*x.shape[:-1], cp))
    out[..., :c] = x
    return out


def kmajor(w_taps: torch.Tensor, dtype: torch.dtype,
           elem_bytes: int = 2) -> torch.Tensor:
    """(taps, Ci, Co) weights -> (taps, Co, padded_channels(Ci,
    elem_bytes)) in ``dtype``, zero-padded, contiguous."""
    return pad_channels(w_taps.to(dtype).transpose(1, 2), elem_bytes)


def conv3x3_weights(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A (3,3,Ci,Co) HWIO kernel as the tensor-core tile's (9, Co, Ci')."""
    ci, co = kernel.shape[2:]
    return kmajor(kernel.reshape(9, ci, co), dtype)


class TilePlan(NamedTuple):
    bh: int          # tile rows
    bw: int          # tile columns; bh * bw = 128, both even
    bn: int          # output channels per block
    bk: int          # input channels per stage: rows of 128 bytes (bf16
                     # 64, int8 128), or of 64 or 32 for a stem
    stages: int      # stages of the TMA ring
    smem_bytes: int  # the block's dynamic shared memory


NO_PLAN = TilePlan(0, 0, 0, 0, 0, 0)   # what an f32 launch passes (ignored)


def staged_bytes(bn: int, out_bytes: int) -> int:
    """Bytes of the epilogue's staged tile: [128][BN] values of
    ``out_bytes`` (2 for bf16, 4 for f32) and 16 bytes of padding a row."""
    return BM * (bn * out_bytes + 16)


def tile_plan(h: int, w: int, ci: int, co: int, out_bytes: int = 2,
              elem_bytes: int = 2) -> TilePlan:
    """The tile of one launch over an (H, W) input with Ci input and Co
    output channels of ``elem_bytes`` bytes (2 bf16, 1 int8). BW is 16
    where W > 8 (8 x 16 patches), else 8 or 4, so narrow images waste
    little of the tile; BH = 128 / BW; both are even, as the fused pool
    needs. BK, in elements, is the padded Ci's depth up to one 128-byte
    swizzled row (bf16 64, int8 128), so a stage holds BM * BK + BN * BK
    elements. BN is the least width the kernel is built for that covers
    Co, at most 256 (one tile reads each input box once for all of Co).
    The ring takes ``RING_BYTES[BN]``: three blocks per SM up to BN = 64,
    one above (64 or 128 accumulators a thread), 2 to 8 stages, and at
    least as many as the staged output tile of ``out_bytes`` per value
    needs (B7's f32 tile at BN = 256 and BK = 16 takes 11). The bytes add
    the 1 KB alignment slack and the 16 bytes of barriers per stage."""
    bw = 16 if w > 8 else (8 if w > 4 else 4)
    bh = BM // bw
    cp = padded_channels(ci, elem_bytes)
    bk = cp if cp <= 64 // elem_bytes else 128 // elem_bytes
    bn = next((b for b in WIDTHS_N if co <= b), WIDTHS_N[-1])
    stage = _round_up((BM + bn) * bk * elem_bytes, ALIGN)
    stages = max(2, min(MAX_STAGES, RING_BYTES[bn] // stage),
                 -(-staged_bytes(bn, out_bytes) // stage))
    return TilePlan(bh, bw, bn, bk, stages, ALIGN + stages * (stage + 16))


def stacked_depth(ci: int, bk: int) -> int:
    """Kp: the K extent of one tap block of B8's stacked weights, the
    padded Ci rounded up to ``bk``."""
    return _round_up(padded_channels(ci), bk)


def stacked_kmajor(k4: torch.Tensor, dtype: torch.dtype,
                   bk: int) -> torch.Tensor:
    """B8's (4, 4*Ci, Co) stacked phase weights (``stacked_phase_kernels``)
    -> (4, Co, 4 * Kp) in ``dtype``, K-major: phase p's tap t at
    ``[t * Kp, t * Kp + Ci)``, zero up to ``(t + 1) * Kp``. Contiguous."""
    ci = k4.shape[1] // 4
    kp = stacked_depth(ci, bk)
    out = k4.new_zeros((4, k4.shape[2], 4, kp), dtype=dtype)
    out[..., :ci] = k4.to(dtype).reshape(4, 4, ci, -1).permute(0, 3, 1, 2)
    return out.reshape(4, k4.shape[2], 4 * kp)


def implicit_gemm_plain(x: torch.Tensor, wk: torch.Tensor,
                        taps: Sequence[tuple], bk: int,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The tensor-core tile's sums in its K order, in ``dtype`` (f32; f64
    holds the int8 kernels' sums exactly) on any device: for each tap (dy,
    dx, widx) in turn, then each ``bk``-channel chunk, x shifted by (dy,
    dx) (zero outside the image) times ``wk[widx]``. x: (N,H,W,C') padded;
    wk: (taps, Co, C'). Returns (N,H,W,Co) in ``dtype``."""
    n, h, w, c = x.shape
    xp = F.pad(x.to(dtype), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, h, w, wk.shape[1]), dtype=dtype, device=x.device)
    for dy, dx, widx in taps:
        xs = xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        wt = wk[widx].to(dtype)
        for c0 in range(0, c, bk):
            acc += xs[..., c0:c0 + bk] @ wt[:, c0:c0 + bk].T
    return acc


def stacked_gemm_plain(x: torch.Tensor, ws: torch.Tensor, phase: int,
                       bk: int) -> torch.Tensor:
    """Kernel B8's sums for output ``phase`` = 2a + b in its K order, in f32
    on any device: one loop over K = 4 * Kp of ``ws[phase]``, stage by
    stage, stage s reading tap t = s // (Kp / bk)'s input shifted by
    (a + t // 2 - 1, b + t % 2 - 1), channels past C' read as zero (as TMA
    reads them). x: (N,H,W,C') padded; ws: (4, Co, 4 * Kp). Returns
    (N,H,W,Co) f32."""
    n, h, w, c = x.shape
    kp = ws.shape[2] // 4
    a, b = phase // 2, phase % 2
    xp = F.pad(x.float(), (0, kp - c, 1, 1, 1, 1))
    wt = ws[phase].float()
    acc = torch.zeros((n, h, w, ws.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, 4 * kp, bk):
        t, c0 = divmod(k0, kp)
        dy, dx = a + t // 2 - 1, b + t % 2 - 1
        xs = xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, c0:c0 + bk]
        acc += xs @ wt[:, k0:k0 + bk].T
    return acc


HEAD_MAX_BN = 128   # the head's epilogue holds U's tile and 24 more sums


def head_rows(cf: int) -> int:
    """Rows of the head's K-major weights: the 9 * Cf taps rounded up to
    16 (one to three n16 column groups of the second product)."""
    return _round_up(9 * cf, 16)


def head_weight_bytes(bn: int, cf: int) -> int:
    """Shared bytes of one block's head weight tile: BN channels in chunks
    of 64 (128-byte swizzled rows) of ``head_rows(cf)`` rows."""
    return -(-bn // 64) * head_rows(cf) * 128


def head_plan(h: int, w: int, ci: int, co: int, cf: int) -> TilePlan:
    """The plan of U's fused head at U's input (H, W, Ci) to Co channels
    and Cf head channels: ``tile_plan``'s tile and ring for BN at most
    ``HEAD_MAX_BN`` (a wider Co takes several channel blocks), and the
    shared bytes for the head's weights behind the ring and its barriers,
    on the swizzle's 1 KB period."""
    p = tile_plan(h, w, ci, min(co, HEAD_MAX_BN))
    stage = _round_up(BM * p.bk * 2 + p.bn * p.bk * 2, ALIGN)
    behind = _round_up(p.stages * (stage + 16), ALIGN)
    return p._replace(smem_bytes=ALIGN + behind + head_weight_bytes(p.bn, cf))


def head_weights(final_kernel: torch.Tensor, dtype: torch.dtype,
                 bn: int) -> torch.Tensor:
    """The head's (3,3,Co,Cf) HWIO kernel as the second product's B
    operand, (head_rows(Cf), Co'), K-major, in ``dtype``: row t * Cf + f
    holds tap t = (t // 3, t % 3)'s weights into channel f; Co' is Co
    rounded up to ``bn``; the padding is zero."""
    co, cf = final_kernel.shape[2:]
    out = final_kernel.new_zeros((head_rows(cf), _round_up(co, bn)),
                                 dtype=dtype)
    out[:9 * cf, :co] = (final_kernel.to(dtype).reshape(9, co, cf)
                         .permute(0, 2, 1).reshape(9 * cf, co))
    return out


def head_workspace_shape(n: int, h: int, w: int, co: int, cf: int,
                         bn: int) -> tuple:
    """The tap partials' shape: (channel blocks, 4 phases, N, H, W,
    9 * Cf), f32. Entry [b, 2a + c, n, i, j, t * Cf + f] is block b's part
    of tap t's contribution to channel f from U pixel (2i + a, 2j + c)."""
    return (-(-co // bn), 4, n, h, w, 9 * cf)
