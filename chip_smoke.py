#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ganreverser_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build the CUDA kernels of ganreverser_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card at the shapes
   of the main path (N = 256, f32 and bf16, TF32 off for the plain f32
   reference): max error against the stated tolerance, median times of the
   kernel, its plain version and the one library call that computes the
   same function (cuDNN's F.conv2d in channels-last for B, U and B6, the
   epilogue, U's upsampling and the pools left out; torch.matmul of rows
   normalised beforehand for C; none for K and B5), and the kernel's bound
   (the larger of its operations over the card's peak for the inputs'
   type and its bytes, each input read once and each output written once,
   over the memory rate). Kernel B6 at D2's five conv + PReLU shapes, the
   slope read from device memory (0.25, and -0.1 on one shape).
   Kernel B5 (dropout) at (256,64,64,64), (256,512) and (256,64,64,3), f32
   and bf16, seeds 12345 and -7: output and gradient bitwise equal to the
   plain version (tolerance 0);
   Kernel K (one kmeans step, f32) at (10,000, 100), K = 20, and at a
   ragged N with an empty cluster, on the same given centroids: the
   assignment must agree wherever the plain margin exceeds 1e-4 of max |d|,
   the counts be those of the kernel's assignment and the sums the plain
   sums over it (1e-4 relative), and a second run be bitwise the same.
   U's fused head at G3's stage 2 (N = 256, C = 3 and 1; library: cuDNN's
   two convolutions in sequence; also timed: kernel U plus the plain head,
   what the unfused fast G runs); kernel B8 (upsample_v2) at G3's two
   stages; kernel B7 (conv_stats) at its probe's (256,64,64,256) -> 128,
   y to the tolerance, the sums within 1e-4 of their magnitudes, bitwise
   repeatable; the three B9 probes exactly their plain versions;
4. the main path at full width: random G3, R and fixer-R (3x64x64, noise
   dim 100, normal noise, non-trivial BN running statistics) saved as
   checkpoints, then ``cli.apply_r.main`` with N = 10,000, 10 needles, batch
   256, bf16 and all six stages. Every kernel must have launched in that
   run (K at least once per Lloyd iteration); every artifact must exist,
   the latents be finite, the cluster counts sum to N, the anomaly count be
   the one the threshold implies and the top-k scores agree with the plain
   search. Then, on the card in f32, the fast path and the fast fixer-R
   against the plain module path (same z, same dropout mask) on 512 rows,
   and latent refinement of 512 of the images: no image's loss may rise,
   and the chunked refiner must match one chunk on 256 rows;
5. R training at full width: a G3 (3x64x64, noise 100) whose BN statistics
   were settled by ``calibrate_batchnorm`` (50 batches) saved as a
   checkpoint, then ``cli.train_r.main`` three times at batch 256, bf16,
   ``--dropout kernel``: 200 batches, 100 more with ``--cont``, and 100 of
   the fixer-R. Each run must launch kernel B5 exactly as often as its
   steps and previews imply (6 forward + 6 backward per step of R, 7 + 6 of
   the fixer-R, whose input needs no gradient, and one per fixer preview),
   give finite losses, write its artifacts; the checkpoint must hold step
   300 with the loss history continued, and load in apply_r's R loader; the
   evaluation MSE on 1,024 held-out latents must fall. Then warm ms/step
   by CUDA events with the kernel and with the plain masks (the median of
   40: two runs of 20 steps each, ordered kernel, plain, plain, kernel),
   and an f32 step that gives the same parameters with the process-wide
   TF32 flags on and off (the backward runs under the precision pin);
6. adversarial training and sampling at full width: ``cli.train.main`` on
   the synthetic faces at 3x64x64, noise 100, batch 256, bf16, 10 batches
   per epoch (the depth cut from the default 30), 2 epochs saved each
   epoch, then ``--network latest`` for a third. Each epoch's losses must
   be finite and its confusion total 10 x 256; the resumed run must go on
   at epoch 3 with the same visualisation noise, the checkpoint hold G and
   D at step 30 and three rows of loss history, and every artifact exist.
   B6 must launch 10 times per epoch (visualize_progress's two D forwards
   of 5 layers) and kernel B's count must not move. Then
   ``cli.sample.main --neighbours --neighbours_max 8192`` on that
   checkpoint: its seven artifacts, B6 launched at least 5 times. Then the
   fast D (B6) against the module D2 on 1,024 images with the kernels
   amplified x3 (f32 1e-4, bf16 2e-2), the warm ms per batch pair (D step
   + G step, b256 bf16 adam, the median of 20 by CUDA events) with the
   peak device memory, and an f32 batch pair (b64, sgd) that gives the
   same G and D parameters with the TF32 flags on and off;
7. pretraining and the probes at full width: ``cli.pretrain_g.main`` at
   3x64x64, noise 100, batch 128, bf16, 2 epochs of 10 batches (the depth
   cut from 30), then one more with ``--network``: finite losses, the
   artifacts, the decoder checkpoint with three rows of loss history, and
   ``cli.train.main --epochs 0`` warm-starting G from it. Then
   ``cli.pretrain_prev.main`` from phase 6's rgb checkpoint at batch 64,
   bf16: 60 batches into yuv at 3x64x64, and 20 into y at 1x32x32 with
   noise 50; each run must launch U's fused head and U (G_prev's two
   stages) once per batch and B6 five times per batch (D_prev), give
   finite losses and a checkpoint at its last batch. Then the three probe
   entry points (``probes.convbn``, ``probes.upsample_v2``,
   ``probes.kernel_probe``) at full size, each launching its kernels.

The last two lines are a JSON object with each kernel's route, source,
launch count in the main path, error, times and bound, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when CUDA is absent or the package is not
beside this file.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
N_CHECK = 256          # rows per kernel check (one chunk of the main path)
N_MAIN = 10_000        # apply_r's N (apply_r.lua:145)
NEEDLES = 10
DIMS, NOISE_DIM = (3, 64, 64), 100
N_COMPARE = 512        # rows of the fast vs plain comparison
# max |kernel - plain| <= TOL * max(1, max |plain|): f32 sums in another
# order; bf16 one rounding per layer at the same places in both versions,
# which may still land on neighbouring bf16 values (1e-2 of the largest
# output is 1.3 to 2.6 bf16 ulps of it)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_SCORES = 1e-4      # cosine scores, inputs cast to f32 in both versions
TOL_PATH = 1e-3        # fast vs plain module path, f32, relative to scale
TOL_SUMS = 1e-4        # kmeans sums vs plain, relative to max(1, max |sum|)
KMEANS_K, KMEANS_ITERS = 20, 15   # apply_r.lua:158
REFINE_STEPS = 5
DROPOUT_SHAPES = [(256, 64, 64, 64), (256, 512), (256, 64, 64, 3)]
DROPOUT_SEEDS = [12345, -7]
# the element dropouts of one R step at batch 256, 64x64, in layer order
# (after blocks 1 and 2, after the first pool, after blocks 4 and 5, after
# the dense layer): their summed time is the kernels line's B5 entry
DROPOUT_STEP_SHAPES = [(256, 64, 64, 64), (256, 64, 64, 64),
                       (256, 32, 32, 64), (256, 32, 32, 128),
                       (256, 32, 32, 128), (256, 512)]
TRAIN_BATCH = 256
CALIBRATE_BATCHES = 50
N_EVAL = 1024          # held-out latents of the evaluation MSE
STEP_TIMES = 20        # steps timed per dropout impl
TOL_PIN = 1e-5         # f32 step, TF32 flags on vs off, relative to scale
# D2's five conv + PReLU layers at 3x64x64 without the batch: label, input
# shape, output channels, PReLU slope, fused pool
D2_B6_LAYERS = [
    ("D2 stem l0 (64,64,3)->128", (64, 64, 3), 128, 0.25, False),
    ("D2 stem l1 (64,64,128)->128+pool", (64, 64, 128), 128, 0.25, True),
    ("D2 right l0 (32,32,128)->128+pool", (32, 32, 128), 128, -0.1, True),
    ("D2 right l2 (16,16,128)->256", (16, 16, 128), 256, 0.25, False),
    ("D2 right l3 (16,16,256)->256+pool", (16, 16, 256), 256, 0.25, True),
]
# fast D (kernel B6) vs the module D2, probabilities: f32 sums in another
# order; in bf16 the module rounds after the bias and multiplies by a bf16
# slope where B6 rounds once
TOL_FAST_D = {"float32": 1e-4, "bfloat16": 2e-2}
GAN_EPOCH_BATCHES = 10   # --N_epoch of phase 6 (depth; the default is 30)
GAN_EPOCHS = 3           # two, then one more after --network latest
N_SAMPLE_NEIGHBOURS = 8192
N_FAST_D = 1024
PAIR_TIMES = 20          # warm batch pairs timed
CONVBN_SHAPE = (256, 64, 64, 256, 128)   # B7's probe: N, H, W, Ci, Co
PRETRAIN_BATCH = 128     # pretrain_g's default --batchSize
PRETRAIN_EPOCH_BATCHES = 10   # --N_epoch of phase 7 (depth; the default 30)
DISTILL_BATCH = 64
# pretrain_prev legs from phase 6's rgb 3x64x64 checkpoint: new colour
# space, height = width, noise dim, batches
DISTILL_LEGS = [("yuv", 64, NOISE_DIM, 60), ("y", 32, 50, 20)]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call of ``fn``, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the card's published peaks (H100 SXM, dense) and memory rate, for the
# least time a kernel's work could take (its bound)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype: str):
    """(ms, "operations" or "bytes"): the larger of the operations over the
    peak rate of the inputs' type and the bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _conv_chain(gen, dev, chans):
    import torch
    ks, scs, shs = [], [], []
    for ci, co in zip(chans[:-1], chans[1:]):
        std = 1.0 / math.sqrt(9 * ci)
        ks.append(std * torch.randn(3, 3, ci, co, device=dev, generator=gen))
        scs.append(0.5 + torch.rand(co, device=dev, generator=gen))
        shs.append(0.1 * torch.randn(co, device=dev, generator=gen))
    return ks, scs, shs


def _nchw_last(x, dtype):
    """NHWC ``x`` as an NCHW channels-last tensor of ``dtype`` (cuDNN's
    native layout for the library timings)."""
    import torch
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _oihw_last(k, dtype):
    import torch
    return k.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def kernel_cases(dev, n: int, n_search: int):
    """(kernel, label, make(dtype) -> case) at the main path's shapes; a
    case holds the kernel's call, its plain version, the library call that
    computes the same function (None where PyTorch has none), and the
    operations and bytes of the function on these inputs."""
    import torch
    import torch.nn.functional as F
    from ganreverser_tpu_torch.ops import (conv_block_kernel as cb,
                                           conv_kernel as ck,
                                           topk_kernel as tk,
                                           upsample_conv_kernel as uc,
                                           upsample_v2_kernel as v2)
    from ganreverser_tpu_torch.ops.upsample_conv import conv_nhwc
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c, h, w = DIMS
    cases = []

    def block(label, shape, chans):
        x0 = torch.rand(shape, device=dev, generator=gen)
        ks, scs, shs = _conv_chain(gen, dev, chans)
        nb, hh, ww, _ = shape

        def make(dtype):
            x = x0.to(dtype)
            xl = _nchw_last(x0, dtype)
            wl = [_oihw_last(k, dtype) for k in ks]

            def library():  # the three convs; epilogues and pool left out
                y = xl
                for wk in wl:
                    y = F.conv2d(y, wk, padding=1)
                return y
            return {"kernel": lambda: cb.conv_block(x, ks, scs, shs,
                                                    act="elu", pool=True),
                    "plain": lambda: cb.conv_block_plain(x, ks, scs, shs,
                                                         act="elu",
                                                         pool=True),
                    "library": library,
                    "flops": sum(2 * nb * hh * ww * 9 * ci * co
                                 for ci, co in zip(chans[:-1], chans[1:])),
                    "bytes": (_nbytes(x, *ks, *scs, *shs) + nb * hh * ww
                              // 4 * chans[-1] * x.element_size())}
        cases.append(("conv_block", label, make))

    def upsample(label, shape, co):
        x0 = torch.rand(shape, device=dev, generator=gen)
        nb, hh, ww, ci = shape
        k = torch.randn(3, 3, ci, co, device=dev, generator=gen) / math.sqrt(
            9 * ci)
        sc = 0.5 + torch.rand(co, device=dev, generator=gen)
        sh = 0.1 * torch.randn(co, device=dev, generator=gen)

        def make(dtype):
            x = x0.to(dtype)
            # the input upsampled beforehand: the call times the 3x3 conv at
            # the output's resolution; epilogue left out
            xl = _nchw_last(x0.repeat_interleave(2, 1).repeat_interleave(2, 2),
                            dtype)
            wl = _oihw_last(k, dtype)
            return {"kernel": lambda: uc.upsample2_conv3x3_bn_act(
                        x, k, sc, sh, act="relu"),
                    "plain": lambda: uc.upsample2_conv3x3_bn_act_plain(
                        x, k, sc, sh, act="relu"),
                    "library": lambda: F.conv2d(xl, wl, padding=1),
                    # four effective taps per output phase
                    "flops": 2 * nb * (2 * hh) * (2 * ww) * 4 * ci * co,
                    "bytes": (_nbytes(x, k, sc, sh)
                              + nb * 4 * hh * ww * co * x.element_size())}
        cases.append(("upsample2_conv3x3_bn_act", label, make))

    def head(label, shape, co, cf, on_path):
        """U's fused head: U, one rounding, the 3x3 Co -> Cf conv +
        sigmoid."""
        x0 = torch.rand(shape, device=dev, generator=gen)
        nb, hh, ww, ci = shape
        k = torch.randn(3, 3, ci, co, device=dev, generator=gen) / math.sqrt(
            9 * ci)
        sc = 0.5 + torch.rand(co, device=dev, generator=gen)
        sh = 0.1 * torch.randn(co, device=dev, generator=gen)
        fk = torch.randn(3, 3, co, cf, device=dev, generator=gen) / math.sqrt(
            9 * co)
        fb = 0.1 * torch.randn(cf, device=dev, generator=gen)

        def make(dtype):
            x = x0.to(dtype)
            xl = _nchw_last(x0.repeat_interleave(2, 1).repeat_interleave(2, 2),
                            dtype)
            wl, fkl = _oihw_last(k, dtype), _oihw_last(fk, dtype)

            def unfused():  # what fused_head=False runs: U, then the head
                u = uc.upsample2_conv3x3_bn_act(x, k, sc, sh, act="relu")
                return torch.sigmoid(conv_nhwc(u, fk, 1, dtype) + fb).to(dtype)
            return {"kernel": lambda: uc.upsample2_conv3x3_head(
                        x, k, sc, sh, fk, fb),
                    "plain": lambda: uc.upsample2_conv3x3_bn_act_plain(
                        x, k, sc, sh, act="relu", final_kernel=fk,
                        final_bias=fb),
                    # cuDNN's two convolutions in sequence (the input
                    # upsampled beforehand; epilogues left out)
                    "library": lambda: F.conv2d(F.conv2d(xl, wl, padding=1),
                                                fkl, padding=1),
                    "unfused": unfused, "on_path": on_path,
                    "flops": 2 * nb * (2 * hh) * (2 * ww) * (
                        4 * ci * co + 9 * co * cf),
                    "bytes": (_nbytes(x, k, sc, sh, fk, fb)
                              + nb * 4 * hh * ww * cf * x.element_size())}
        cases.append(("upsample2_conv3x3_head", label, make))

    def upsample_v2(label, shape, co):
        x0 = torch.rand(shape, device=dev, generator=gen)
        nb, hh, ww, ci = shape
        k = torch.randn(3, 3, ci, co, device=dev, generator=gen) / math.sqrt(
            9 * ci)
        sc = 0.5 + torch.rand(co, device=dev, generator=gen)
        sh = 0.1 * torch.randn(co, device=dev, generator=gen)

        def make(dtype):
            x = x0.to(dtype)
            xl = _nchw_last(x0.repeat_interleave(2, 1).repeat_interleave(2, 2),
                            dtype)
            wl = _oihw_last(k, dtype)
            return {"kernel": lambda: v2.upsample_v2(x, k, sc, sh),
                    "plain": lambda: v2.upsample_v2_plain(x, k, sc, sh),
                    "library": lambda: F.conv2d(xl, wl, padding=1),
                    "flops": 2 * nb * (2 * hh) * (2 * ww) * 4 * ci * co,
                    "bytes": (_nbytes(x, k, sc, sh)
                              + nb * 4 * hh * ww * co * x.element_size())}
        cases.append(("upsample_v2", label, make))

    def search(label, d, positive):
        e0 = torch.randn(n_search, d, device=dev, generator=gen)
        if positive:  # pixels are sigmoid outputs in [0, 1]
            e0 = torch.sigmoid(e0)
        idx = torch.tensor([(i + 1) * 100 - 1 for i in range(NEEDLES)],
                           device=dev)
        en = e0 / e0.norm(dim=1, keepdim=True)
        qn = en[idx]

        def make(dtype):
            e = e0.to(dtype)
            return {"kernel": lambda: tk.cosine_scores(e, idx),
                    "plain": lambda: tk.cosine_scores_plain(e, idx),
                    # one product of rows normalised beforehand
                    "library": lambda: torch.matmul(qn, en.T),
                    "flops": 2 * NEEDLES * n_search * d + 2 * n_search * d,
                    "bytes": (_nbytes(e, idx)
                              + NEEDLES * n_search * 4)}
        cases.append(("cosine_scores", label, make))

    def conv_prelu(label, shape, co, alpha, pool):
        x0 = torch.rand(shape, device=dev, generator=gen)
        nb, hh, ww, ci = shape
        k = torch.randn(3, 3, ci, co, device=dev, generator=gen) / math.sqrt(
            9 * ci)
        ones = torch.ones(co, device=dev)
        bias = 0.1 * torch.randn(co, device=dev, generator=gen)
        a = torch.tensor([alpha], device=dev)  # read from device memory
        oh, ow = (hh // 2, ww // 2) if pool else (hh, ww)

        def make(dtype):
            x = x0.to(dtype)
            xl = _nchw_last(x0, dtype)
            wl = _oihw_last(k, dtype)
            return {"kernel": lambda: ck.conv3x3_bn_act(
                        x, k, ones, bias, act="prelu", prelu_alpha=a,
                        pool=pool),
                    "plain": lambda: ck.conv3x3_bn_act_plain(
                        x, k, ones, bias, act="prelu", prelu_alpha=a,
                        pool=pool),
                    # the convolution alone: bias, PReLU and pool left out
                    "library": lambda: F.conv2d(xl, wl, padding=1),
                    "flops": 2 * nb * hh * ww * 9 * ci * co,
                    "bytes": (_nbytes(x, k, ones, bias, a)
                              + nb * oh * ow * co * x.element_size())}
        cases.append(("conv3x3_bn_act", label, make))

    block(f"R block 1 ({n},{h},{w},{c})->64x3+pool", (n, h, w, c),
          [c, 64, 64, 64])
    block(f"R block 2 ({n},{h // 2},{w // 2},64)->128x3+pool",
          (n, h // 2, w // 2, 64), [64, 128, 128, 128])
    upsample(f"G stage 1 ({n},{h // 4},{w // 4},512)->256",
             (n, h // 4, w // 4, 512), 256)
    upsample(f"G stage 2 ({n},{h // 2},{w // 2},256)->128",
             (n, h // 2, w // 2, 256), 128)
    search(f"attributes ({n_search},{NOISE_DIM}) x {NEEDLES}", NOISE_DIM,
           False)
    search(f"pixels ({n_search},{c * h * w}) x {NEEDLES}", c * h * w, True)
    # D2's five conv + PReLU layers (stem l0, l1+pool; right branch
    # l0+pool, l2, l3+pool), one with a negative slope
    for label, shape, co, alpha, pool in D2_B6_LAYERS:
        conv_prelu(label, (n,) + shape, co, alpha, pool)
    # U's fused head at G3's stage 2: C = 3 (pretrain_prev's G_prev), and
    # C = 1 (a grayscale G_prev)
    for cf in (3, 1):
        head(f"G stage 2 + head ({n},{h // 2},{w // 2},256)->128->{cf}",
             (n, h // 2, w // 2, 256), 128, cf, cf == c)
    upsample_v2(f"G stage 1 ({n},{h // 4},{w // 4},512)->256",
                (n, h // 4, w // 4, 512), 256)
    upsample_v2(f"G stage 2 ({n},{h // 2},{w // 2},256)->128",
                (n, h // 2, w // 2, 256), 128)
    return cases


def check_kernels(dev, card: str, n: int = N_CHECK, n_search: int = N_MAIN):
    """Phase 3: every kernel against its plain version; returns one record
    per (kernel, shape, dtype) with the times of the kernel, its plain
    version and the library call, and the kernel's bound."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    records = []
    for name, label, make in kernel_cases(dev, n, n_search):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            case = make(dtype)
            kern, plain = case["kernel"], case["plain"]
            out = kern()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ref = plain()
            check(out.shape == ref.shape and out.dtype == ref.dtype,
                  f"{name} {label} {dname}: {tuple(out.shape)} {out.dtype} "
                  f"vs plain {tuple(ref.shape)} {ref.dtype}")
            check(bool(torch.isfinite(out).all()),
                  f"{name} {label} {dname}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            tol = (TOL_SCORES if name == "cosine_scores"
                   else TOL[dname] * scale)
            del out, ref
            ms, plain_ms = time_ms(kern), time_ms(plain)
            lib_ms = time_ms(case["library"])
            b_ms, b_by = bound(case["flops"], case["bytes"], dname)
            unfused = (f", unfused U + head {time_ms(case['unfused']):.4f} ms"
                       if "unfused" in case else "")
            print(f"[kernel] {name} {label} {dname}: max_abs_err {err:.3e} "
                  f"(tol {tol:.1e}), kernel {ms:.4f} ms, plain {plain_ms:.4f}"
                  f" ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}){unfused}  [{card}]")
            check(err <= tol, f"{name} {label} {dname}: max_abs_err {err} "
                  f"> tol {tol}")
            records.append({"name": name, "label": label, "dtype": dname,
                            "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "on_path": case.get("on_path", True)})
    return records


def kmeans_case(x, c):
    """Kernel K against its plain version on the same centroids. Returns
    (max |kernel sums - plain sums over the kernel's assignment|, its
    tolerance, rows whose assignment differs from the plain one)."""
    import torch
    from ganreverser_tpu_torch.ops import kmeans_kernel as kk
    new_c, counts, sums, assign = kk.kmeans_step(x, c, details=True)
    torch.cuda.synchronize()
    again = kk.kmeans_step(x, c, details=True)
    check(all(torch.equal(a, b) for a, b in zip((new_c, counts, sums, assign),
                                                again)),
          "kmeans_step: two runs differ")
    _, _, _, ref_assign = kk.kmeans_step_plain(x, c, details=True)
    d = (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)
    top2 = torch.topk(d, 2, dim=1, largest=False).values
    sure = (top2[:, 1] - top2[:, 0]) > 1e-4 * d.abs().max()
    flipped = int((assign != ref_assign).sum())
    check(torch.equal(assign[sure], ref_assign[sure]),
          "kmeans_step: assignment differs from plain beyond the margin")
    k = c.shape[0]
    check(torch.equal(counts, torch.bincount(assign, minlength=k).float()),
          "kmeans_step: counts are not those of its assignment")
    ref_sums = torch.nn.functional.one_hot(assign, k).float().T @ x
    err = (sums - ref_sums).abs().max().item()
    tol = TOL_SUMS * max(1.0, ref_sums.abs().max().item())
    check(err <= tol, f"kmeans_step: sums differ from plain by {err} > {tol}")
    ref_new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp_min(counts, 1.0)[:, None], c)
    check(torch.equal(new_c, ref_new),
          "kmeans_step: centroids are not sums / counts")
    return err, tol, flipped


def check_kmeans(dev, card: str, n: int = N_MAIN):
    """Phase 3, kernel K: a Lloyd step at the main path's shape, and at a
    ragged N with an empty cluster; returns one record."""
    import torch
    from ganreverser_tpu_torch.ops import kmeans_kernel as kk
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn(n, NOISE_DIM, device=dev, generator=gen)
    c = x[torch.randperm(n, device=dev, generator=gen)[:KMEANS_K]]
    err, tol, flipped = kmeans_case(x, c)
    ms = time_ms(lambda: kk.kmeans_step(x, c))
    plain_ms = time_ms(lambda: kk.kmeans_step_plain(x, c))
    print(f"[kernel] kmeans_step ({n},{NOISE_DIM}) K={KMEANS_K} float32: "
          f"sums max_abs_err {err:.3e} (tol {tol:.1e}), "
          f"{flipped} near-tie rows assigned otherwise, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms per Lloyd step  [{card}]")
    xr = x[:777]
    cr = c.clone()
    cr[-1] = 0.0
    cr[-1, 0] = 50.0  # no row comes near: an empty cluster
    err_r, tol_r, flipped_r = kmeans_case(xr, cr)
    counts = kk.kmeans_step(xr, cr)[1]
    check(counts[-1].item() == 0.0, "kmeans_step: the far cluster is not "
          "empty")
    print(f"[kernel] kmeans_step ragged (777,{NOISE_DIM}) K={KMEANS_K} with "
          f"an empty cluster: sums max_abs_err {err_r:.3e} (tol {tol_r:.1e}), "
          f"{flipped_r} "
          f"near-tie rows  [{card}]")
    b_ms, b_by = bound(2 * n * KMEANS_K * NOISE_DIM + n * NOISE_DIM,
                       4 * (n * NOISE_DIM + 2 * KMEANS_K * NOISE_DIM
                            + KMEANS_K), "float32")
    return {"name": "kmeans_step", "label": f"({n},{NOISE_DIM}) K={KMEANS_K}",
            "dtype": "float32", "max_abs_err": max(err, err_r), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by}


def make_models(dev, dims=DIMS, noise_dim=NOISE_DIM):
    """Phase 4a: G3, R and the fixer-R with seeded random weights and
    non-trivial BN running statistics."""
    import torch
    from ganreverser_tpu_torch.models import modules, zoo
    gen = torch.Generator().manual_seed(SEED)
    models = []
    for model in (zoo.create_G3(dims, noise_dim),
                  zoo.create_R(dims, noise_dim, "normal"),
                  zoo.create_R(dims, noise_dim, "normal", fixer=True)):
        modules.init_parameters(model, gen)
        for m in model.modules():
            if isinstance(m, modules.BatchNorm):
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, generator=gen))
                m.var.copy_(0.5 + torch.rand(m.var.shape, generator=gen))
        models.append(model.to(dev))
    return models


def save_models(G, R, RF, save: str, dims=DIMS,
                noise_dim=NOISE_DIM) -> str:
    """Checkpoints laid out as apply_r expects; returns G's path."""
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.models.bridge import export_variables
    c, h, w = dims
    cfg = {"noiseDim": noise_dim, "noiseMethod": "normal",
           "colorSpace": "rgb", "height": h, "width": w}
    g_path = ckpt.adversarial_name(save)
    ckpt.save_checkpoint(g_path, {"G": export_variables(G)}, config=cfg)
    for model, fixer in ((R, False), (RF, True)):
        ckpt.save_checkpoint(ckpt.r_name(save, c, h, w, noise_dim, "normal",
                                         fixer),
                             {"R": export_variables(model)}, config=cfg)
    return g_path


def kernel_counters():
    from ganreverser_tpu_torch.ops import (conv_block_kernel,
                                           kmeans_kernel, topk_kernel,
                                           upsample_conv_kernel)
    return {"conv_block": conv_block_kernel.conv_block,
            "upsample2_conv3x3_bn_act":
                upsample_conv_kernel.upsample2_conv3x3_bn_act,
            "cosine_scores": topk_kernel.cosine_scores,
            "kmeans_step": kmeans_kernel.kmeans_step}


def run_main_path(g_path: str, save: str, out_dir: str, n: int = N_MAIN,
                  needles: int = NEEDLES, batch: int = 256,
                  dtype: str = "bfloat16"):
    """Phase 4b: apply_r through its entry point, counting kernel launches
    in that run only. Returns (result, launches, seconds)."""
    from ganreverser_tpu_torch.cli import apply_r
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = apply_r.main(["--G", g_path, "--save", save, "--writeto",
                           out_dir, "--N", str(n), "--needles", str(needles),
                           "--batchSize", str(batch), "--compute_dtype",
                           dtype])
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    return result, launches, seconds


def check_main_path(result, out_dir: str, n: int = N_MAIN,
                    needles: int = NEEDLES, noise_dim: int = NOISE_DIM):
    """Phase 4c: every artifact, finite latents, cluster counts summing to
    N, the anomaly count the threshold implies, search scores vs plain.
    Returns the two top-k score errors."""
    import torch
    from ganreverser_tpu_torch.ops.topk_kernel import cosine_scores_plain
    names = ["variations.jpg", "fixed_pairs.jpg", "fixed_images_528.jpg",
             "fixed_images_528_unfixed.jpg", "anomalies.jpg",
             "apply_r_stats.jsonl"]
    names += [f"similar_{tag}_{i:02d}.jpg" for i in range(1, needles + 1)
              for tag in ("attributes", "pixelwise")]
    with open(os.path.join(out_dir, "apply_r_stats.jsonl")) as f:
        stats = [json.loads(line) for line in f]
    sizes = [r["value"] for r in stats if r["tag"] == "cluster_size"]
    names += [f"cluster_{ci + 1:02d}.jpg" for ci, size in enumerate(sizes)
              if size > 0]
    for name in names:
        check(os.path.isfile(os.path.join(out_dir, name)), f"missing {name}")
    check(len(sizes) == KMEANS_K and sum(sizes) == n,
          f"cluster sizes {sizes} do not sum to {n}")
    check(result["counts"].sum().item() == n,
          f"kmeans counts sum to {result['counts'].sum().item()}, not {n}")
    scores, thr = result["scores"], result["threshold"]
    implied = int((scores <= thr).sum())
    n_calc = scores.shape[0]
    flagged = int(result["is_anomaly"].sum())
    count = [r["value"] for r in stats if r["tag"] == "anomaly_count"]
    check(flagged == implied == count[0] and implied >= int(n_calc * 0.15),
          f"anomalies: {flagged} flagged, {implied} implied by the "
          f"threshold, {count} in the stats")
    attrs, images = result["attributes"], result["images"]
    for name in ("attributes", "attributes_fixer"):
        check(tuple(result[name].shape) == (n, noise_dim),
              f"{name} shape {tuple(result[name].shape)}")
        check(bool(torch.isfinite(result[name]).all()), f"non-finite {name}")
    for name in ("images", "fixed", "variations"):
        check(bool(torch.isfinite(result[name]).all()), f"non-finite {name}")
    idx = torch.tensor([(i + 1) * 100 - 1 for i in range(needles)],
                       device=attrs.device)
    errs = []
    for emb, (scores, _) in ((attrs, result["attr_topk"]),
                             (images.reshape(n, -1), result["pix_topk"])):
        ref = torch.topk(cosine_scores_plain(emb, idx), scores.shape[1],
                         dim=1).values
        errs.append((scores - ref).abs().max().item())
    check(max(errs) <= TOL_SCORES,
          f"top-k scores differ from the plain search by {max(errs)}")
    return errs


def _path_err(what: str, a, b) -> float:
    err = (a - b).abs().max().item()
    scale = max(1.0, b.abs().max().item())
    check(err <= TOL_PATH * scale,
          f"fast vs plain {what}: {err} > {TOL_PATH * scale}")
    return err


def compare_paths(G, R, RF, dev, n: int = N_COMPARE, dims=DIMS,
                  noise_dim=NOISE_DIM):
    """Phase 4d: fast path (kernels) vs the plain module path, f32, on the
    same z, and the fast fixer vs the module fixer-R on the same dropout
    mask. Returns the image, latent and fixer-latent errors."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models import bridge, fastpath
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    z = noise_inputs(gen, n, noise_dim, "normal", device=dev)
    g_vars, r_vars, rf_vars = (
        bridge.to_torch(bridge.export_variables(m), dev) for m in (G, R, RF))
    f32 = torch.float32
    with torch.inference_mode():
        fast_images = fastpath.make_fast_generator(dims, noise_dim, f32)(
            g_vars, z)
        fast_z = fastpath.make_fast_inverter(dims, noise_dim, "normal", f32)(
            r_vars, fast_images)
        fast_zf = fastpath.make_fast_fixer(dims, noise_dim, "normal", f32)(
            rf_vars, fast_images,
            torch.Generator(device=dev).manual_seed(SEED + 5))
        plain_images = G(z)
        plain_z = R(plain_images)
        RF.l0.generator = torch.Generator(device=dev).manual_seed(SEED + 5)
        plain_zf = RF(fast_images)
    return (_path_err("images", fast_images, plain_images),
            _path_err("latents", fast_z, plain_z),
            _path_err("fixer latents", fast_zf, plain_zf))


def check_refine(G, images, z0, n_chunk: int = 256):
    """Phase 4e: adam on z through the module G (f32) for the images and
    first guesses given: no image's loss may rise, and the chunked refiner
    must match one chunk on ``n_chunk`` rows. Returns (loss before, after,
    chunk error, seconds)."""
    import torch
    from ganreverser_tpu_torch.analysis.refine import make_refiner
    f32 = torch.float32
    images, z0 = images.float(), z0.float()
    _, loss0 = make_refiner(G, steps=0, dtype=f32)(images, z0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, loss = make_refiner(G, steps=REFINE_STEPS, dtype=f32,
                           batch_size=256)(images, z0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(bool(torch.isfinite(z).all()), "refine: non-finite latents")
    rose = int((loss > loss0).sum())
    check(rose == 0, f"refine: the loss rose on {rose} of {len(loss)} "
          f"images (max rise {(loss - loss0).max().item():.3e})")
    za, _ = make_refiner(G, steps=REFINE_STEPS, dtype=f32,
                         batch_size=n_chunk // 2)(images[:n_chunk],
                                                  z0[:n_chunk])
    zb, _ = make_refiner(G, steps=REFINE_STEPS, dtype=f32)(images[:n_chunk],
                                                           z0[:n_chunk])
    err = _path_err("refined latents, chunked vs one chunk", za, zb)
    return loss0.mean().item(), loss.mean().item(), err, seconds


def dropout_case(x, seed: int, rate: float = 0.5):
    """Kernel B5 against its plain version on ``x``: output and gradient
    (of a random cotangent) must be bitwise equal. Returns the largest
    absolute difference seen (0 when they are equal)."""
    import torch
    from ganreverser_tpu_torch.ops import dropout_kernel as dk
    s = torch.tensor([seed], dtype=torch.int32, device=x.device)
    go = torch.randn(x.shape, device=x.device,
                     generator=torch.Generator(device=x.device).manual_seed(
                         seed & 0xFFFF)).to(x.dtype)
    outs = []
    for fn in (dk.fused_dropout, dk.fused_dropout_plain):
        xi = x.detach().clone().requires_grad_(True)
        y = fn(xi, s, rate)
        (g,) = torch.autograd.grad(y, xi, go)
        outs.append((y.detach(), g))
    torch.cuda.synchronize()
    (y, g), (yr, gr) = outs
    err = max((y.float() - yr.float()).abs().max().item(),
              (g.float() - gr.float()).abs().max().item())
    check(torch.equal(y, yr) and torch.equal(g, gr),
          f"fused_dropout {tuple(x.shape)} {x.dtype} seed {seed}: kernel "
          f"and plain differ (max {err})")
    return err


def check_dropout(dev, card: str):
    """Phase 3, kernel B5: bitwise against the plain version at the
    path's shapes, both dtypes, a negative seed among the seeds; the
    forward's median time, kernel vs plain. Returns one record whose times
    are one R step's six element dropouts in bf16."""
    import torch
    from ganreverser_tpu_torch.ops import dropout_kernel as dk
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    err = 0.0
    for shape in DROPOUT_SHAPES:
        x0 = torch.randn(shape, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            for seed in DROPOUT_SEEDS:
                err = max(err, dropout_case(x0.to(dtype), seed))
        print(f"[kernel] fused_dropout {shape} f32+bf16 seeds "
              f"{DROPOUT_SEEDS}: forward and backward bitwise equal to "
              f"plain  [{card}]")
    s = torch.tensor([DROPOUT_SEEDS[0]], dtype=torch.int32, device=dev)
    times = {}
    for shape in dict.fromkeys(DROPOUT_STEP_SHAPES + DROPOUT_SHAPES):
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        times[shape] = (time_ms(lambda: dk.fused_dropout(x, s, 0.5)),
                        time_ms(lambda: dk.fused_dropout_plain(x, s, 0.5)),
                        time_ms(lambda: torch.where(
                            torch.rand(shape, device=dev, generator=gen) < 0.5,
                            x / 0.5, 0.0).to(x.dtype)))
        ms, plain_ms, mask_ms = times[shape]
        gbs = 2 * x.numel() * x.element_size() / ms / 1e6
        print(f"[kernel] fused_dropout {shape} bfloat16 forward: kernel "
              f"{ms:.4f} ms ({gbs:.0f} GB/s), plain hash {plain_ms:.4f} ms, "
              f"plain Bernoulli mask + where {mask_ms:.4f} ms  [{card}]")
    ms = sum(times[sh][0] for sh in DROPOUT_STEP_SHAPES)
    plain_ms = sum(times[sh][1] for sh in DROPOUT_STEP_SHAPES)
    mask_ms = sum(times[sh][2] for sh in DROPOUT_STEP_SHAPES)
    print(f"[kernel] fused_dropout, one R step's six forwards (b256 bf16): "
          f"kernel {ms:.4f} ms, plain hash {plain_ms:.4f} ms, plain "
          f"Bernoulli mask + where {mask_ms:.4f} ms  [{card}]")
    # one read and one write of each bf16 input, one multiply per element
    elems = sum(math.prod(sh) for sh in DROPOUT_STEP_SHAPES)
    b_ms, b_by = bound(elems, 4 * elems, "bfloat16")
    return {"name": "fused_dropout", "label": "one R step's six dropouts",
            "dtype": "bfloat16", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by}


def check_conv_stats(dev, card: str):
    """Phase 3, kernel B7 at its probe's full size (256,64,64,256)->128, f32
    and bf16: y within TOL of the plain conv, each channel's sum and sumsq
    within TOL_SUMS of the summed magnitudes, a second run bitwise equal.
    Returns the bf16 and f32 records."""
    import torch
    import torch.nn.functional as F
    from ganreverser_tpu_torch.ops import conv_stats_kernel as cs
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    n, h, w, ci, co = CONVBN_SHAPE
    x0 = 0.5 * torch.randn(n, h, w, ci, device=dev, generator=gen)
    k = 0.05 * torch.randn(3, 3, ci, co, device=dev, generator=gen)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        x = x0.to(dtype)
        y, s, q = cs.conv_stats(x, k)
        torch.cuda.synchronize()
        again = cs.conv_stats(x, k)
        check(all(torch.equal(a, b) for a, b in zip((y, s, q), again)),
              f"conv_stats {dname}: two runs differ")
        del again
        ry, rs, rq = cs.conv_stats_plain(x, k)
        err = (y - ry).abs().max().item()
        tol = TOL[dname] * max(1.0, ry.abs().max().item())
        check(err <= tol, f"conv_stats {dname}: y max_abs_err {err} > {tol}")
        mag = ry.abs().sum(dim=(0, 1, 2))
        err_s = ((s - rs).abs() / torch.clamp_min(mag, 1.0)).max().item()
        err_q = ((q - rq).abs() / torch.clamp_min(rq, 1.0)).max().item()
        check(max(err_s, err_q) <= TOL_SUMS,
              f"conv_stats {dname}: sums off by {err_s}, {err_q} of their "
              f"magnitudes > {TOL_SUMS}")
        del y, s, q, ry, rs, rq, mag
        xl, wl = _nchw_last(x0, dtype), _oihw_last(k, dtype)
        ms = time_ms(lambda: cs.conv_stats(x, k))
        plain_ms = time_ms(lambda: cs.conv_stats_plain(x, k))
        lib_ms = time_ms(lambda: F.conv2d(xl, wl, padding=1))
        del xl, wl
        b_ms, b_by = bound(2 * n * h * w * 9 * ci * co,
                           _nbytes(x, k) + n * h * w * co * 4 + 2 * co * 4,
                           dname)
        print(f"[kernel] conv_stats ({n},{h},{w},{ci})->{co} {dname}: y "
              f"max_abs_err {err:.3e} (tol {tol:.1e}), sums within "
              f"{max(err_s, err_q):.3e} of their magnitudes, bitwise "
              f"repeatable; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library (the conv alone) {lib_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by})  [{card}]")
        records.append({"name": "conv_stats",
                        "label": f"({n},{h},{w},{ci})->{co}", "dtype": dname,
                        "max_abs_err": max(err, err_s, err_q), "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "on_path": True})
    return records


def check_probe_kernels(dev, card: str):
    """Phase 3, kernel B9 at the TPU probes' shapes: +1 on (8,128) f32, x2
    on (4,256,128) f32, a (128,128) x (128,128) bf16 product to f32 on
    small-integer operands; each exactly its plain version. Returns one
    record per probe."""
    import torch
    from ganreverser_tpu_torch.ops import probe_kernels as pk
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    x = torch.randn(8, 128, device=dev, generator=gen)
    x3 = torch.randn(4, 256, 128, device=dev, generator=gen)
    a = torch.randint(-3, 4, (128, 128), device=dev, generator=gen).to(
        torch.bfloat16)
    b = torch.randint(-3, 4, (128, 128), device=dev, generator=gen).to(
        torch.bfloat16)
    cases = [("add_one", "(8,128)", "float32", lambda: pk.add_one(x),
              lambda: pk.add_one_plain(x), lambda: x + 1.0, x.numel(),
              2 * _nbytes(x)),
             ("times_two", "(4,256,128), 4 blocks", "float32",
              lambda: pk.times_two(x3), lambda: pk.times_two_plain(x3),
              lambda: x3 * 2.0, x3.numel(), 2 * _nbytes(x3)),
             ("dot_bf16", "(128,128) x (128,128)", "bfloat16",
              lambda: pk.dot_bf16(a, b), lambda: pk.dot_bf16_plain(a, b),
              lambda: torch.matmul(a.float(), b.float()), 2 * 128 ** 3,
              _nbytes(a, b) + 128 * 128 * 4)]
    records = []
    for name, label, dname, kern, plain, library, flops, nbytes in cases:
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        check(out.dtype == ref.dtype and torch.equal(out, ref),
              f"{name} {label}: kernel and plain differ")
        err = (out.float() - ref.float()).abs().max().item()
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(library)
        b_ms, b_by = bound(flops, nbytes, dname)
        print(f"[kernel] {name} {label} {dname}: exactly the plain version; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})  [{card}]")
        records.append({"name": name, "label": label, "dtype": dname,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "on_path": True})
    return records


def make_calibrated_g(dev, dims=DIMS, noise_dim=NOISE_DIM,
                      batch: int = TRAIN_BATCH,
                      n_batches: int = CALIBRATE_BATCHES):
    """Phase 5a: a random f32 G3 whose BN statistics were settled by the
    port's calibrate_batchnorm (random weights otherwise give a G whose
    output hardly depends on z)."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models import modules, zoo
    from ganreverser_tpu_torch.train.r_loop import calibrate_batchnorm
    G = modules.init_parameters(zoo.create_G3(dims, noise_dim),
                                torch.Generator().manual_seed(SEED + 6))
    G = G.to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    return calibrate_batchnorm(
        G, lambda i: noise_inputs(gen, batch, noise_dim, "normal",
                                  device=dev), n_batches)


def eval_mse(G, R, z) -> float:
    """Mean squared error of R(G(z)) against z, both in evaluation."""
    import torch
    from ganreverser_tpu_torch.train.r_loop import make_r_eval_step
    with torch.no_grad():
        z_hat = make_r_eval_step(R)(G.eval()(z))
    return ((z_hat.float() - z) ** 2).mean().item()


def train_run(args, fixer: bool, n_batches: int):
    """Phase 5b: one ``cli.train_r.main`` run with B5's count set to 0 just
    before and read just after; the count must be the run's steps times
    the launches of one step, plus one per fixer preview."""
    from ganreverser_tpu_torch.cli import train_r
    from ganreverser_tpu_torch.ops import dropout_kernel as dk
    dk.fused_dropout.launches = 0
    t0 = time.perf_counter()
    out = train_r.main(args)
    seconds = time.perf_counter() - t0
    launches = dk.fused_dropout.launches
    per_step = (7 if fixer else 6) + 6
    previews = (n_batches // 25 + n_batches // 100) if fixer else 0
    check(launches == n_batches * per_step + previews,
          f"train_r{' --fixer' if fixer else ''}: B5 launched {launches} "
          f"times, expected {n_batches} x {per_step} + {previews}")
    losses = out["losses"]
    check(len(losses) == n_batches and all(map(math.isfinite, losses)),
          f"train_r: {len(losses)} losses, or a non-finite one")
    return out, launches, seconds


def step_times(G, R_state, dev, impl: str, batch: int = TRAIN_BATCH):
    """Warm ms per R train step (median of STEP_TIMES, CUDA events) at
    batch 256 bf16 with the given dropout impl, from R's state dict."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models import modules, zoo
    from ganreverser_tpu_torch.optim import adam
    from ganreverser_tpu_torch.train.r_loop import make_r_train_step
    from ganreverser_tpu_torch.train.state import TrainState
    R = zoo.create_R(DIMS, NOISE_DIM, "normal", dtype=torch.bfloat16,
                     dropout_impl=impl)
    R.load_state_dict(R_state)
    modules.set_dropout_generator(
        R.to(dev), torch.Generator(device=dev).manual_seed(SEED + 8))
    ts = TrainState.create(R, adam())
    step = make_r_train_step(G, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    zs = [noise_inputs(gen, batch, NOISE_DIM, "normal", device=dev)
          for _ in range(4)]
    for i in range(3):
        step(ts, zs[i % 4])
    times = []
    for i in range(STEP_TIMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(ts, zs[i % 4])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def precision_pin_error(G, dev, dims=DIMS, noise_dim=NOISE_DIM,
                        batch: int = 64) -> float:
    """Phase 5e: one f32 R train step through the f32 module ``G`` with the
    process-wide TF32 flags on,
    then off, from the same weights, latents and dropout masks; returns the
    largest parameter difference relative to max(1, max |param|). The step
    uses sgd (lr 0.1), whose update is linear in the gradient, so a TF32
    backward (about 1e-3 relative) would show; adam's sign-like first step
    would hide it in all but the near-zero entries."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models import modules, zoo
    from ganreverser_tpu_torch.optim import sgd
    from ganreverser_tpu_torch.train.r_loop import make_r_train_step
    from ganreverser_tpu_torch.train.state import TrainState
    z = noise_inputs(torch.Generator(device=dev).manual_seed(SEED + 10),
                     batch, noise_dim, "normal", device=dev)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    params = []
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            R = modules.init_parameters(
                zoo.create_R(dims, noise_dim, "normal", dropout_impl="kernel"),
                torch.Generator().manual_seed(SEED + 11)).to(dev)
            modules.set_dropout_generator(
                R, torch.Generator(device=dev).manual_seed(SEED + 12))
            opt = sgd(lr=0.1)
            make_r_train_step(G, dtype=torch.float32, opt=opt)(
                TrainState.create(R, opt), z)
            check(torch.backends.cudnn.allow_tf32 == tf32,
                  "the train step left the TF32 flags changed")
            params.append([p.detach().clone() for p in R.parameters()])
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
    return max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip(*params))


def check_training(dev, card: str, tmp: str):
    """Phase 5: R training at full width through cli.train_r.main (see the
    module docstring). Returns the B5 launches of the three runs."""
    import torch
    from ganreverser_tpu_torch.cli.apply_r import _load_variables
    from ganreverser_tpu_torch.core.prng import INIT_STAGE, stage_generator
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.models import bridge, fastpath, modules, zoo
    c, h, w = DIMS
    t0 = time.perf_counter()
    G = make_calibrated_g(dev)
    save = os.path.join(tmp, "train")
    g_path = ckpt.adversarial_name(save)
    ckpt.save_checkpoint(g_path, {"G": bridge.export_variables(G)},
                         config={"noiseDim": NOISE_DIM,
                                 "noiseMethod": "normal", "colorSpace": "rgb",
                                 "height": h, "width": w})
    bf16 = torch.bfloat16
    Gb = zoo.create_G3(DIMS, NOISE_DIM, bf16).to(dev)
    Gb.load_state_dict(G.state_dict())
    z_eval = torch.randn(N_EVAL, NOISE_DIM, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED + 13))
    # R as train_r initialises it (seed 1, the init stage)
    R0 = modules.init_parameters(
        zoo.create_R(DIMS, NOISE_DIM, "normal", dtype=bf16),
        stage_generator(1, INIT_STAGE, "cpu")).to(dev)
    mse0 = eval_mse(Gb, R0, z_eval)
    print(f"[train] G calibrated ({CALIBRATE_BATCHES} batches) and saved in "
          f"{time.perf_counter() - t0:.2f} s")

    base = ["--G", g_path, "--save", save, "--batchSize", str(TRAIN_BATCH),
            "--compute_dtype", "bfloat16", "--dropout", "kernel"]
    runs = []
    out, n, secs = train_run(base + ["--nbBatches", "200", "--saveFreq",
                                     "200"], False, 200)
    runs.append(n)
    r_path = out["checkpoint"]
    print(f"[train] train_r b{TRAIN_BATCH} bf16 --dropout kernel, 200 "
          f"batches: {secs:.2f} s, B5 launches {n} (200 x 12), loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}  [{card}]")
    out, n, secs = train_run(base + ["--nbBatches", "100", "--saveFreq",
                                     "200", "--cont", r_path], False, 100)
    runs.append(n)
    tree, _, extra = ckpt.load_checkpoint(r_path)
    check(out["ts"].step == 300 and int(tree["R"]["step"]) == 300
          and extra["batch"] == 300,
          f"--cont: checkpoint at step {int(tree['R']['step'])}, not 300")
    rows = [row[0] for row in extra["plot_data"]]
    check(rows == [100, 200, 300], f"--cont: plot_data batches {rows}")
    mse1 = eval_mse(Gb, out["ts"].module, z_eval)
    check(mse1 < mse0, f"eval MSE did not fall: {mse0} -> {mse1}")
    r_vars = _load_variables(r_path, "R", dev)
    with torch.no_grad():
        z_fast = fastpath.make_fast_inverter(DIMS, NOISE_DIM, "normal", bf16)(
            r_vars, Gb(z_eval[:TRAIN_BATCH]))
    check(bool(torch.isfinite(z_fast).all()),
          "the trained R loaded in apply_r's loader gives non-finite z")
    print(f"[train] --cont to batch 300: {secs:.2f} s, B5 launches {n}; "
          f"checkpoint step 300, plot_data batches {rows}; eval MSE on "
          f"{N_EVAL} held-out z {mse0:.4f} -> {mse1:.4f}; loads in "
          f"apply_r's R loader  [{card}]")
    out_f, n, secs = train_run(base + ["--fixer", "--nbBatches", "100"],
                               True, 100)
    runs.append(n)
    print(f"[train] --fixer, 100 batches: {secs:.2f} s, B5 launches {n} "
          f"(100 x 13 + 5 previews)  [{card}]")
    for name in ("events_r.jsonl", "images_r/plot_r_loss.png",
                 "images_r/g_r_g_000100.png", r_path + "_fixer"):
        check(os.path.exists(os.path.join(save, name)), f"missing {name}")

    state = out["ts"].module.state_dict()
    kern, plain = [], []
    for impl in ("kernel", "plain", "plain", "kernel"):
        (kern if impl == "kernel" else plain).extend(
            step_times(Gb, state, dev, impl))
    ms_k, ms_p = statistics.median(kern), statistics.median(plain)
    print(f"[train] ms/step, warm, b{TRAIN_BATCH} bf16, median of "
          f"{len(kern)} by CUDA events: --dropout kernel {ms_k:.3f} ms, "
          f"--dropout threefry (plain masks) {ms_p:.3f} ms  [{card}]")
    err = precision_pin_error(G, dev)
    check(err <= TOL_PIN, f"f32 train step differs with TF32 on vs off by "
          f"{err} > {TOL_PIN}")
    print(f"[train] f32 step (b64, sgd), TF32 flags on vs off: parameters "
          f"within {err:.3e} of scale (tol {TOL_PIN:.0e})  [{card}]")
    return sum(runs)


def make_d2(dev, dims=DIMS, dtype=None, amplify: float = 3.0):
    """A random D2 in ``dtype`` (f32 by default) whose conv and dense
    kernels are amplified (random-init D2 outputs sit at 0.5) and whose
    biases are small and random."""
    import torch
    from ganreverser_tpu_torch.models import modules, zoo
    gen = torch.Generator().manual_seed(SEED + 14)
    D = modules.init_parameters(zoo.create_D(dims, dtype or torch.float32),
                                gen)
    with torch.no_grad():
        for name, prm in D.named_parameters():
            if name.endswith("kernel"):
                prm.mul_(amplify)
            elif name.endswith("bias"):
                prm.copy_(0.1 * torch.randn(prm.shape, generator=gen))
    return D.to(dev)


def fast_d_error(dev, dtype, n: int = N_FAST_D, dims=DIMS,
                 launches: int = 5) -> float:
    """D2's fast evaluation forward (kernel B6) against the module D2 on
    the same amplified weights and ``n`` random images; B6 must launch
    ``launches`` times. Returns the largest probability difference
    relative to max(1, max |module|)."""
    import torch
    from ganreverser_tpu_torch.models import bridge, fastpath
    from ganreverser_tpu_torch.ops import conv_kernel
    D = make_d2(dev, dims, dtype)
    c, h, w = dims
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x = torch.rand(n, h, w, c, device=dev, generator=gen)
    rate = fastpath.make_fast_discriminator(dims, dtype)
    with torch.no_grad():
        before = conv_kernel.conv3x3_bn_act.launches
        fast = rate(bridge.module_variables(D), x)
        torch.cuda.synchronize()
        got = conv_kernel.conv3x3_bn_act.launches - before
        ref = D.eval()(x)
    check(got == launches, f"fast D launched B6 {got} times, not {launches}")
    check(fast.shape == ref.shape == (n, 1) and fast.dtype == ref.dtype,
          f"fast D {tuple(fast.shape)} {fast.dtype} vs module "
          f"{tuple(ref.shape)} {ref.dtype}")
    ref = ref.float()
    check(bool(((ref > 0.05) & (ref < 0.95)).any()),
          "amplified D2's probabilities are all saturated")
    return ((fast.float() - ref).abs().max().item()
            / max(1.0, ref.abs().max().item()))


def make_gan(dev, dtype, opt, dims=DIMS, noise_dim=NOISE_DIM):
    """A GanState of random G3 and D2 in ``dtype`` with ``opt``, D's
    dropouts drawing from a seeded generator on the card."""
    import torch
    from ganreverser_tpu_torch.models import modules, zoo
    from ganreverser_tpu_torch.train.state import GanState, TrainState
    gen = torch.Generator().manual_seed(SEED + 15)
    G = modules.init_parameters(zoo.create_G(dims, noise_dim, dtype), gen)
    D = modules.init_parameters(zoo.create_D(dims, dtype), gen)
    modules.set_dropout_generator(
        D.to(dev), torch.Generator(device=dev).manual_seed(SEED + 17))
    return GanState(g=TrainState.create(G.to(dev), opt),
                    d=TrainState.create(D, opt))


def _gan_batches(dev, batch: int, n: int, dims=DIMS,
                 noise_dim=NOISE_DIM):
    """``n`` (real half, D's latents, G's latents) triples on the card: the
    real halves are synthetic faces (data/synthetic.py)."""
    import numpy as np
    import torch
    from ganreverser_tpu_torch.data.synthetic import synthetic_faces
    c, h, w = dims
    faces = synthetic_faces(n * batch // 2, h, w,
                            np.random.default_rng(SEED))[..., :c]
    reals = torch.from_numpy(faces).to(dev).reshape(n, batch // 2, h, w, c)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    return [(reals[i],
             torch.randn(batch // 2, noise_dim, device=dev, generator=gen),
             torch.randn(batch, noise_dim, device=dev, generator=gen))
            for i in range(n)]


def pair_times(dev, batch: int = TRAIN_BATCH):
    """Warm ms per batch pair (one D step + one G step) at ``batch``, bf16,
    adam: PAIR_TIMES pairs by CUDA events after 3 warm-up pairs. Returns
    (times, peak device memory in bytes over the timed pairs)."""
    import torch
    from ganreverser_tpu_torch.optim import adam
    from ganreverser_tpu_torch.train.adversarial import (
        Confusion, make_adversarial_steps)
    bf16 = torch.bfloat16
    gs = make_gan(dev, bf16, adam())
    d_step, g_step = make_adversarial_steps(dtype=bf16)
    confusion = Confusion.zero(dev)
    batches = _gan_batches(dev, batch, 4)
    for real, zd, zg in batches[:3]:
        d_step(gs, real, zd, confusion)
        g_step(gs, zg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(PAIR_TIMES):
        real, zd, zg = batches[i % 4]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        d_step(gs, real, zd, confusion)
        g_step(gs, zg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, torch.cuda.max_memory_allocated(dev)


def gan_pin_error(dev, batch: int = 64) -> float:
    """One f32 batch pair (sgd, lr 0.1: the update is linear in the
    gradient, so a TF32 forward or backward would show) with the
    process-wide TF32 flags on, then off, from the same weights, data,
    latents and dropout masks; returns the largest G or D parameter
    difference relative to max(1, max |param|)."""
    import torch
    from ganreverser_tpu_torch.optim import sgd
    from ganreverser_tpu_torch.train.adversarial import (
        Confusion, make_adversarial_steps)
    f32 = torch.float32
    real, zd, zg = _gan_batches(dev, batch, 1)[0]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    params = []
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            opt = sgd(lr=0.1)
            gs = make_gan(dev, f32, opt)
            d_step, g_step = make_adversarial_steps(
                dtype=f32, d_optimizer=opt, g_optimizer=opt)
            d_step(gs, real, zd, Confusion.zero(dev))
            g_step(gs, zg)
            check(torch.backends.cudnn.allow_tf32 == tf32,
                  "the GAN steps left the TF32 flags changed")
            params.append([q.detach().clone() for m in (gs.g, gs.d)
                           for q in m.module.parameters()])
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
    return max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip(*params))


def check_gan(dev, card: str, tmp: str):
    """Phase 6: adversarial training and sampling at full width through
    cli.train.main and cli.sample.main (see the module docstring). Returns
    B6's launches in the two train runs and in the sample run."""
    import torch
    from ganreverser_tpu_torch.cli import sample, train
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.ops import conv_kernel
    c, h, w = DIMS
    save = os.path.join(tmp, "gan")
    base = ["--dataset", "synthetic", "--save", save, "--height", str(h),
            "--width", str(w), "--noiseDim", str(NOISE_DIM), "--batchSize",
            str(TRAIN_BATCH), "--compute_dtype", "bfloat16", "--N_epoch",
            str(GAN_EPOCH_BATCHES), "--saveFreq", "1"]
    per_epoch = 2 * 5  # visualize_progress: two D forwards of 5 B6 layers
    runs = []
    for extra, epochs in ((["--epochs", "2"], [1, 2]),
                          (["--epochs", "3", "--network", "latest"], [3])):
        conv_kernel.conv3x3_bn_act.launches = 0
        t0 = time.perf_counter()
        out = train.main(base + extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = conv_kernel.conv3x3_bn_act.launches
        runs.append((out, n, secs))
        check(n == per_epoch * len(epochs),
              f"train {extra}: B6 launched {n} times, expected "
              f"{per_epoch} x {len(epochs)} epochs")
        check([r["epoch"] for r in out["epochs"]] == epochs,
              f"train {extra}: epochs {[r['epoch'] for r in out['epochs']]}")
        for r in out["epochs"]:
            total = sum(map(sum, r["counts"]))
            check(total == GAN_EPOCH_BATCHES * TRAIN_BATCH,
                  f"epoch {r['epoch']}: confusion total {total}")
            losses = r["d_losses"] + r["g_losses"]
            check(len(losses) == 2 * GAN_EPOCH_BATCHES
                  and all(map(math.isfinite, losses)),
                  f"epoch {r['epoch']}: {len(losses)} losses or a "
                  "non-finite one")
        print(f"[gan] train {' '.join(extra)}: {secs:.2f} s, B6 launches {n}"
              f"; epochs " + "; ".join(
                  f"{r['epoch']}: d {statistics.mean(r['d_losses']):.4f} "
                  f"g {statistics.mean(r['g_losses']):.4f} "
                  f"counts {r['counts']}" for r in out["epochs"])
              + f"  [{card}]")
    (first, _, _), (second, _, _) = runs
    check(torch.equal(first["vis_noise"], second["vis_noise"]),
          "the resumed run has another visualisation noise")
    path = ckpt.adversarial_name(save)
    tree, _, extra = ckpt.load_checkpoint(path)
    rows = [row[0] for row in extra["plot_data"]]
    steps = (int(tree["G"]["step"]), int(tree["D"]["step"]))
    check(extra["epoch"] == 3 and rows == [1, 2, 3]
          and steps == (3 * GAN_EPOCH_BATCHES,) * 2,
          f"checkpoint: epoch {extra['epoch']}, plot_data {rows}, "
          f"G/D steps {steps}")
    names = ["events.jsonl", "adversarial/manifest.json",
             "images/plot_loss.png"]
    names += [f"images/{tag}_{e:06d}.png" for e in (1, 2, 3)
              for tag in ("samples", "best", "worst")]
    for name in names:
        check(os.path.exists(os.path.join(save, name)), f"missing {name}")

    out_dir = os.path.join(tmp, "samples")
    conv_kernel.conv3x3_bn_act.launches = 0
    t0 = time.perf_counter()
    sampled = sample.main(["--network", path, "--writeto", out_dir,
                           "--dataset", "synthetic", "--neighbours",
                           "--neighbours_max", str(N_SAMPLE_NEIGHBOURS),
                           "--compute_dtype", "bfloat16"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_sample = conv_kernel.conv3x3_bn_act.launches
    check(n_sample >= 5, f"sample: B6 launched {n_sample} times")
    for name in ("trainset", "samples_256", "samples_1024", "best_64",
                 "worst_64", "random_64", "neighbours"):
        check(os.path.isfile(os.path.join(out_dir, name + ".jpg")),
              f"sample: missing {name}.jpg")
    check(bool(torch.isfinite(torch.from_numpy(sampled["preds"])).all()),
          "sample: non-finite scores")
    print(f"[gan] sample 1,024 images, --neighbours over "
          f"{N_SAMPLE_NEIGHBOURS}: {secs:.2f} s, B6 launches {n_sample}; "
          f"checkpoint epoch 3, plot_data epochs {rows}, G/D steps {steps}"
          f"  [{card}]")
    return runs[0][1] + runs[1][1], n_sample


def check_pretraining(dev, card: str, tmp: str, prev_path: str):
    """Phase 7: the pretraining CLIs and the probe entry points at full
    width (see the module docstring). Returns the launches of the new
    kernels in their runs."""
    import numpy as np
    import torch
    from ganreverser_tpu_torch.cli import pretrain_g, pretrain_prev, train
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.models.bridge import export_variables
    from ganreverser_tpu_torch.ops import (conv_kernel, conv_stats_kernel,
                                           probe_kernels,
                                           upsample_conv_kernel,
                                           upsample_v2_kernel)
    from ganreverser_tpu_torch.probes import convbn, kernel_probe, upsample_v2
    c, h, w = DIMS
    uc = upsample_conv_kernel
    launches = {}

    # pretrain_g: 2 epochs, then one more resumed with --network
    save = os.path.join(tmp, "pretrain_g")
    base = ["--dataset", "synthetic", "--save", save, "--height", str(h),
            "--width", str(w), "--noiseDim", str(NOISE_DIM), "--batchSize",
            str(PRETRAIN_BATCH), "--N_epoch", str(PRETRAIN_EPOCH_BATCHES),
            "--compute_dtype", "bfloat16"]
    t0 = time.perf_counter()
    out = pretrain_g.main(base + ["--epochs", "2", "--saveFreq", "1"])
    path = out["checkpoint"]
    out2 = pretrain_g.main(base + ["--epochs", "1", "--network", path])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = out["losses"] + out2["losses"]
    check(len(losses) == 3 and all(map(math.isfinite, losses)),
          f"pretrain_g: losses {losses}")
    for name in ("events_pretrain_g.jsonl", "images_pretrain_g/plot_g_loss.png",
                 "images_pretrain_g/ae_recon_000001.png",
                 "images_pretrain_g/ae_recon_000002.png",
                 os.path.basename(path)):
        check(os.path.exists(os.path.join(save, name)),
              f"pretrain_g: missing {name}")
    tree, _, extra = ckpt.load_checkpoint(path)
    rows = [row[0] for row in extra["plot_data"]]
    check(rows == [1, 2, 3], f"pretrain_g: plot_data epochs {rows}")
    warm = train.main(["--dataset", "synthetic", "--save",
                       os.path.join(tmp, "warm"), "--G_pretrained_dir", save,
                       "--height", str(h), "--width", str(w), "--noiseDim",
                       str(NOISE_DIM), "--epochs", "0", "--noplot"])
    got = export_variables(warm["gs"].g.module)
    check(all(np.array_equal(a, tree[part][layer][leaf])
              for part in ("params", "state")
              for layer, leaves in got[part].items()
              for leaf, a in leaves.items()),
          "train did not warm-start G from pretrain_g's checkpoint")
    print(f"[pretrain] pretrain_g b{PRETRAIN_BATCH} bf16, 2 epochs of "
          f"{PRETRAIN_EPOCH_BATCHES} batches + 1 resumed with --network: "
          f"{secs:.2f} s, last batch losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; plot_data epochs {rows}; train warm-starts G from it  "
          f"[{card}]")

    # pretrain_prev from phase 6's rgb checkpoint: two legs
    launches["upsample2_conv3x3_head"] = 0
    for cs_new, size, nd, batches in DISTILL_LEGS:
        for fn in (uc.upsample2_conv3x3_head, uc.upsample2_conv3x3_bn_act,
                   conv_kernel.conv3x3_bn_act):
            fn.launches = 0
        t0 = time.perf_counter()
        out = pretrain_prev.main([
            "--network", prev_path, "--dataset", "synthetic", "--save",
            os.path.join(tmp, f"distill_{cs_new}"), "--batchSize",
            str(DISTILL_BATCH), "--N_batches", str(batches), "--colorSpace",
            cs_new, "--height", str(size), "--width", str(size),
            "--noiseDim", str(nd), "--compute_dtype", "bfloat16"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_head = uc.upsample2_conv3x3_head.launches
        n_u = uc.upsample2_conv3x3_bn_act.launches
        n_b6 = conv_kernel.conv3x3_bn_act.launches
        check((n_head, n_u, n_b6) == (batches, batches, 5 * batches),
              f"pretrain_prev {cs_new}: head, U and B6 launched {n_head}, "
              f"{n_u}, {n_b6} times, expected {batches}, {batches}, "
              f"{5 * batches}")
        losses = out["g_losses"] + out["d_losses"]
        check(len(losses) == 2 * batches and all(map(math.isfinite, losses)),
              f"pretrain_prev {cs_new}: {len(losses)} losses or a "
              "non-finite one")
        tree, cfg, extra = ckpt.load_checkpoint(out["checkpoint"])
        check(extra["batches"] == batches and cfg["colorSpace"] == cs_new
              and int(tree["D"]["step"]) == batches,
              f"pretrain_prev {cs_new}: checkpoint at {extra['batches']}")
        launches["upsample2_conv3x3_head"] += n_head
        print(f"[pretrain] pretrain_prev rgb 3x{h}x{w} nd{NOISE_DIM} -> "
              f"{cs_new} {size}x{size} nd{nd}, b{DISTILL_BATCH} bf16, "
              f"{batches} batches: {secs:.2f} s ({secs / batches * 1e3:.1f} "
              f"ms per batch); launches head {n_head}, U {n_u}, B6 {n_b6}; "
              f"loss G {out['g_losses'][0]:.4f} -> {out['g_losses'][-1]:.4f}"
              f", D {out['d_losses'][0]:.4f} -> {out['d_losses'][-1]:.4f}  "
              f"[{card}]")

    # the three probe entry points at full size
    for name, fn, counters in (
            ("convbn", convbn.main, [conv_stats_kernel.conv_stats]),
            ("upsample_v2", upsample_v2.main, [upsample_v2_kernel.upsample_v2]),
            ("kernel_probe", kernel_probe.main,
             [probe_kernels.add_one, probe_kernels.times_two,
              probe_kernels.dot_bf16])):
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        result = fn([])
        torch.cuda.synchronize()
        check(result != 1, f"probe {name} failed")
        for k in counters:
            check(k.launches > 0, f"probe {name}: {k.__name__} launched no "
                  "time")
            launches[k.__name__] = k.launches
        print(f"[pretrain] probe {name}: {time.perf_counter() - t0:.2f} s, "
              "launches " + ", ".join(f"{k.__name__} {k.launches}"
                                      for k in counters) + f"  [{card}]")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    try:
        from ganreverser_tpu_torch.ops import cuda_lib
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.environ["GANREVERSER_PLATFORM"] = "gpu"

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"[card] torch: {kind}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.parent / f"build_{cuda_lib.source_hash()}.log"
    if log.is_file():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    # 3. kernels against their plain versions
    records = check_kernels(dev, card)
    records.append(check_kmeans(dev, card))
    records.append(check_dropout(dev, card))
    records += check_conv_stats(dev, card)
    records += check_probe_kernels(dev, card)

    # 4. the main path at full width
    G, R, RF = make_models(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        save, out_dir = os.path.join(tmp, "logs"), os.path.join(tmp, "out")
        g_path = save_models(G, R, RF, save)
        result, launches, seconds = run_main_path(g_path, save, out_dir)
        for name, count in launches.items():
            check(count > 0, f"kernel {name} launched no time in the main "
                  "path")
        check(launches["kmeans_step"] >= KMEANS_ITERS,
              f"kmeans_step launched {launches['kmeans_step']} times, fewer "
              f"than the {KMEANS_ITERS} Lloyd iterations")
        score_errs = check_main_path(result, out_dir)
    secs = result["seconds"]
    print(f"[main] apply_r N={N_MAIN} bf16 batch 256, all six stages + "
          f"fixer-R: whole call {seconds:.2f} s; launches {launches}; top-k "
          f"score error vs plain {max(score_errs):.2e}  [{card}]")
    print(f"[main] stage seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in secs.items()) +
        f"; generate+invert {N_MAIN / secs['generate_invert']:.1f} img/s "
        f"(G, R and the fixer-R)  [{card}]")
    loss0, loss1, chunk_err, refine_s = check_refine(
        G, result["images"][:N_COMPARE], result["attributes"][:N_COMPARE])
    print(f"[main] refine {N_COMPARE} images, {REFINE_STEPS} adam steps, f32 "
          f"module G: mean pixel MSE {loss0:.4e} -> {loss1:.4e}, no image "
          f"rose; {refine_s:.3f} s; chunked vs one chunk on 256 rows "
          f"max_abs_err {chunk_err:.3e}  [{card}]")
    del result
    img_err, z_err, zf_err = compare_paths(G, R, RF, dev)
    print(f"[main] fast vs plain module path, f32, {N_COMPARE} rows: images "
          f"max_abs_err {img_err:.3e}, latents {z_err:.3e}, fixer latents "
          f"(same mask) {zf_err:.3e}  [{card}]")

    # 5. R training at full width
    del G, R, RF
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches["fused_dropout"] = check_training(dev, card, tmp)

    # 6. adversarial training and sampling at full width
    t6 = time.perf_counter()
    b_before = kernel_counters()["conv_block"].launches
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        n_train, n_sample = check_gan(dev, card, tmp)
        check(kernel_counters()["conv_block"].launches == b_before,
              "phase 6 moved kernel B's count")
        # 7. pretraining from phase 6's checkpoint, and the probes
        t7 = time.perf_counter()
        from ganreverser_tpu_torch.io import checkpoint as ckpt
        launches.update(check_pretraining(
            dev, card, tmp, ckpt.adversarial_name(os.path.join(tmp, "gan"))))
        secs7 = time.perf_counter() - t7
    launches["conv3x3_bn_act"] = n_train + n_sample
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        err = fast_d_error(dev, dtype)
        check(err <= TOL_FAST_D[dname], f"fast D vs module D {dname}: {err} "
              f"> {TOL_FAST_D[dname]}")
        print(f"[gan] fast D (B6) vs module D2, {N_FAST_D} images, kernels "
              f"x3, {dname}: max prob error {err:.3e} (tol "
              f"{TOL_FAST_D[dname]:.0e})  [{card}]")
    times, peak = pair_times(dev)
    print(f"[gan] ms per batch pair (D step + G step), warm, b{TRAIN_BATCH} "
          f"bf16 adam, median of {len(times)} by CUDA events: "
          f"{statistics.median(times):.3f} ms (min {min(times):.3f}, max "
          f"{max(times):.3f}); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB  [{card}]")
    err = gan_pin_error(dev)
    check(err <= TOL_PIN, f"f32 batch pair differs with TF32 on vs off by "
          f"{err} > {TOL_PIN}")
    print(f"[gan] f32 batch pair (b64, sgd), TF32 flags on vs off: G and D "
          f"parameters within {err:.3e} of scale (tol {TOL_PIN:.0e})  "
          f"[{card}]")
    print(f"[time] phases 6 and 7 {time.perf_counter() - t6:.1f} s (7: "
          f"{secs7:.1f} s), the whole run {time.perf_counter() - t_start:.1f}"
          f" s  [{card}]")

    sources = {"conv_block": ("ganreverser_tpu_torch/csrc/conv_block.cu",
                              "ganreverser_tpu/ops/conv_block_kernel.py:86"),
               "upsample2_conv3x3_bn_act": (
                   "ganreverser_tpu_torch/csrc/upsample_conv.cu",
                   "ganreverser_tpu/ops/upsample_conv_kernel.py:122"),
               "cosine_scores": ("ganreverser_tpu_torch/csrc/cosine_scores.cu",
                                 "ganreverser_tpu/ops/topk_kernel.py:69"),
               "kmeans_step": ("ganreverser_tpu_torch/csrc/kmeans.cu",
                               "ganreverser_tpu/ops/kmeans_kernel.py:97"),
               "fused_dropout": ("ganreverser_tpu_torch/csrc/dropout.cu",
                                 "ganreverser_tpu/ops/dropout_kernel.py:70"),
               "conv3x3_bn_act": ("ganreverser_tpu_torch/csrc/conv_block.cu",
                                  "ganreverser_tpu/ops/conv_kernel.py:87"),
               "upsample2_conv3x3_head": (
                   "ganreverser_tpu_torch/csrc/upsample_conv.cu",
                   "ganreverser_tpu/ops/upsample_conv_kernel.py:98"),
               "conv_stats": ("ganreverser_tpu_torch/csrc/conv_stats.cu",
                              "benchmarks/convbn_probe.py:85"),
               "upsample_v2": ("ganreverser_tpu_torch/csrc/upsample_v2.cu",
                               "benchmarks/tpu_upsample_v2.py:69"),
               "add_one": ("ganreverser_tpu_torch/csrc/probes.cu",
                           "benchmarks/tpu_pallas_probe.py:48"),
               "times_two": ("ganreverser_tpu_torch/csrc/probes.cu",
                             "benchmarks/tpu_pallas_probe.py:63"),
               "dot_bf16": ("ganreverser_tpu_torch/csrc/probes.cu",
                            "benchmarks/tpu_pallas_probe.py:80")}
    f32_lines = ("kmeans_step", "add_one", "times_two")
    kernels = []
    for name, (source, replaces) in sources.items():
        # the main path's dtype (bf16; kmeans and two probes run in f32),
        # summed over the path's shapes (the head's C = 3 row: G_prev is
        # rgb); B5's launches are those of the three train_r runs, B6's
        # those of the two train runs and the sample run, the head's those
        # of the two pretrain_prev runs, B7-B9's those of their probes
        recs = [r for r in records if r["name"] == name and r["dtype"] == (
            "float32" if name in f32_lines else "bfloat16")
            and r.get("on_path", True)]
        libs = [r["library_ms"] for r in recs]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": sum(r["ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": sum(r["bound_ms"] for r in recs),
            "bound_by": max(recs, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in libs else sum(libs)})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
