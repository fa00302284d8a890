#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ganreverser_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build the CUDA kernels of ganreverser_tpu_torch/csrc with nvcc, print
   each kernel's registers, spills and stack from the build log (-Xptxas
   -v), the main path's tile plans (their shared bytes) beside B7's and
   B8's, the 64-bit IMAD.WIDE count of B5's pack kernel (its address
   arithmetic; the hash is 32-bit), and the SASS guard: cuobjdump -sass of the built library must show
   HGMMA (tensor-core) instructions in every instance (one per BN) of the
   six bf16 kernels, conv3x3_wgmma_kernel (B, B6), upsample2_wgmma_kernel
   (U), conv_stats_wgmma_kernel (B7), upsample_v2_wgmma_kernel (B8),
   upsample2_head_wgmma_kernel (U's fused head, BN 16 to 128) and
   cosine_wgmma_kernel (C), as many per instance as before Q1 and Q2 moved
   onto their mainloop (HGMMA_COUNTS), and some in every instance of
   kernel D's dense_bf16_wgmma_kernel and dense_bf16_split_wgmma_kernel
   (none in its dense_bf16_sum_kernel); IGMMA (the int8 tensor cores' s8
   wgmma) in every instance of Q1's, Q2's and Q3's
   quant_conv3x3_s8_kernel, quant_upsample2_s8_kernel,
   quant_dense_s8_kernel and quant_dense_split_s8_kernel, neither in Q3's
   sum kernel and Q4's kernels, and no DP4A in any kernel;
3. each kernel against its plain PyTorch version on the card at the shapes
   of the main path (N = 256, f32 and bf16, TF32 off for the plain f32
   reference): max error against the stated tolerance, median times of the
   kernel, its plain version and the one library call that computes the
   same function (cuDNN's F.conv2d in channels-last for B, U and B6, the
   epilogue, U's upsampling and the pools left out; torch.matmul of rows
   normalised beforehand for C; none for K and B5), and the kernel's bound
   (the larger of its operations over the card's peak for the inputs'
   type and its bytes, each input read once and each output written once,
   over the memory rate). Kernel C at apply_r's two searches (10,000 rows,
   10 needles) and at the fused e2e program's needle chunk (10,240 rows,
   256 needles), D = 100 and 12,288. Kernel B6 at D2's five conv + PReLU
   shapes, the slope read from device memory (0.25, and -0.1 on one
   shape).
   Kernel B5 (dropout) at one R step's six shapes, (256,512) and
   (256,64,64,3), f32 and bf16, seeds 12345 and -7: output and gradient
   bitwise equal to the plain version (tolerance 0), a second forward
   bitwise the first; the bf16 forward's wrapper time and device time
   (torch.profiler) at every shape, the (256,512) call being host cost;
   Kernel K (f32) at (10,000, 100), K = 20 and K = 256 (apply_r --clusters
   256), and at a ragged N with an empty cluster: one step (kmeans_step)
   and the whole run of 15 Lloyd iterations in one launch (kmeans_lloyd),
   each iteration held against the plain step from the kernel's own
   centroids: the assignment must agree wherever the plain margin exceeds
   1e-4 of max |d|, the counts be those of the kernel's assignment, the
   sums the plain sums over it (1e-4 relative) and bitwise the segment
   order's (kmeans_segment_sums_plain), and two runs be bitwise the same;
   with no near-tie row assigned otherwise the run must end within 1e-4 of
   the plain run (kmeans_lloyd_plain); wrapper and device times of the run;
   U's fused head at G3's stage 2 (N = 256, C = 3 and 1; library: cuDNN's
   two convolutions in sequence; also timed for reference: kernel U plus
   the head as a separate convolution). In bf16 the head and C each run two
   launches whose second adds partials in a fixed order: a second call
   must give bitwise the first's output. Kernel B8 (upsample_v2) at G3's two
   stages, also against kernel U on the same inputs (time, and within the
   probe's tolerance: f32 1e-4, bf16 3e-2 of the output's scale); kernel
   B7 (conv_stats) at its probe's (256,64,64,256) -> 128,
   y to the tolerance, the sums within 1e-4 of their magnitudes, bitwise
   repeatable; the three B9 probes exactly their plain versions, with
   their wrapper and device (torch.profiler) times. StyleGAN2's FIR
   filter (csrc/fir.cu) at the 16 shapes of one refine step of config F
   (``portbench/configs/sg2f_ffhq1024.json``), batch 8, bf16: forward and
   backward through ``fir_filter`` against ``upfirdn2d_plain`` within
   1e-5 of the largest output (the f32 sums' order), one bf16 step more
   for the gradient rounded to bf16; kernel, plain, library (cuDNN's
   depthwise F.conv2d / F.conv_transpose2d of f32 operands, the module
   path's filter before the kernel) and bound times; then one forward and
   backward of config F at batch 8 must launch it twice per FIRFilter
   (32) and copy no input. Kernel D (csrc/dense.cu, the fast forwards'
   bf16 dense layers) at G l0, R l27 and R l31 of 3x64x64 z 100 and
   3x128x128 z 256, batch 128 (every shape the fused program gives it):
   within dense_close of its plain version (one bf16 step of the larger
   value plus 2^-14 of the sum of |x w|: the same exact
   products summed in f32 in other orders), its wrapper and device times,
   its plain version's (the f32 product and three passes it replaced),
   the library's (torch.mm of the bf16 operands with an f32 output, and
   the same passes) and its byte bound;
4. the main path at full width: random G3, R and fixer-R (3x64x64, noise
   dim 100, normal noise, non-trivial BN running statistics) saved as
   checkpoints, then ``cli.apply_r.main`` with N = 10,000, 10 needles, batch
   256, bf16 and all six stages. Every kernel must have launched in that
   run (K once: one launch for all Lloyd iterations); every artifact must exist,
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
   TF32 flags on and off (the backward runs under the precision pin;
   cuDNN held to deterministic algorithms in both legs);
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
   same G and D parameters with the TF32 flags on and off (cuDNN held
   deterministic);
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
   ``probes.kernel_probe``) at full size, each launching its kernels;
8. the fused generate -> invert -> top-k program (analysis/e2e.py) at full
   width, as bench.py times JAX's: phase 4's G3 and R, N = 10,240 latents,
   bf16, k = 100, needle chunk 256, the fast G (kernel U and U's fused
   head) and the fast R (kernel B), their dense layers on kernel D, kernel
   C in the search. Its first call (warm-up, capture, replay) is the path
   whose launches count; a second replay must add to U's, B's, C's and
   D's counts exactly as many launches as the chunks imply (U 80, head
   80, B 480, C 40, D 240: G l0, R l27 and R l31), a traced third
   must run as many of their kernels on the device (torch.profiler), and
   the replays must give bitwise the first call's results,
   which must be bitwise the eager program's (capture=False) and the
   serial programs' (generate-all, invert-all, search-all); the top-k
   values must be within 1e-5 of the plain search on the same embeddings
   (cosine_scores_plain + torch.topk), each returned row's plain score
   within 1e-5 of its value, and the index sets equal on every row whose
   k-th score leads the (k+1)-th by more than that; a call with other
   weights (G's and R's kernels x 3) must give what the eager program
   gives on them, and hold the same checks with at least one row so
   separated. The same with the pixel measure (pixel_k = 100), for both
   pairs of weights, against the search in f64 on the serial program's
   images, also within 1e-5 (the plain f32 search's own sums of 12,288
   products lie up to about 1e-4 from the exact scores), the other
   weights' with at least one row separated.
   Printed: img/s of the fused graph, the
   eager program and the serial graphs at batch 128, of batch 256 and of
   the pixel measure; the
   peak device memory of the fused and the serial programs' first calls;
   the search through kernel C against torch.matmul of normalised rows,
   each + torch.topk;
9. the Torch7 import at full width, the reference user's path: phase 4's
   G3, R and fixer-R and an amplified D2 (3x64x64, noise 100) as the
   reference's networks in torch's layouts (NCHW, nn.Copy at both ends,
   cudnn convs in G, createNxN sub-Sequentials and an nn.Concat in D),
   written by this script's own t7 writer as train.lua's adversarial file
   (epoch 4, loss history, visualisation noise) and train_r.lua's R and
   fixer-R files; ``cli.show.main`` on the adversarial file, then
   ``cli.import_t7.main`` on each (seconds printed) and ``cli.show.main``
   on each checkpoint, whose parameter counts must be the reference
   networks'. The fast G (kernel U; U's fused head), R (B) and D (B6) on
   the imported weights against the NCHW reference forwards (f32, TF32
   off, 512 rows, TOL_PATH); ``cli.apply_r.main`` on the imported
   checkpoints with phase 4's arguments and checks (B, U, C, K must
   launch); one ``cli.train.main --network <imported>`` epoch of 10
   batches, which must be epoch 5 with the file's visualisation noise and
   launch B6 10 times; G3, D2 and R drawn on the card from a CUDA
   generator under each --init, every layer within its half-width;
10. serving and the int8 legs, from phase 4's checkpoints (the same seed):
   ``cli.export.main`` writes the invert (batch 256), generate (batch 256)
   and e2e (N = 10,240, batch 128, k = 100) artifacts in bf16, each with
   ``--check``; a fresh process that imports only
   ``ganreverser_tpu_torch.io.serving`` (and this script's timers) loads
   each on the card (one CUDA graph), runs it on the inputs the live legs
   get, counts its kernels in one traced call (invert B 6, D 2; generate
   U 1, U's head 1, D 1; e2e U 80, U's head 80, B 480, C 40, D 240),
   times the e2e
   artifact warm, then loads the invert artifact on the CPU; it must have
   imported nothing under models/, cli/ or analysis/e2e.py. The loaded
   outputs must be within 1e-3 x max(1, scale) of the live legs', the
   e2e top-k within 1e-5 of the f64 search, the CPU leg's 16 rows within
   1e-2 of the plain path. Printed beside phase 8's live graph: export
   seconds, artifact MB, load and first-call seconds, the loaded e2e
   artifact's warm img/s. Then kernels Q1-Q4 (csrc/quant.cu) against
   their plain versions at the int8 legs' shapes (R's six convs, G's
   output conv, G's two upsample stages, the three dense layers; Q4's two
   launches at the two entry quantisers' sizes, its one pass at the eight
   sizes that follow a producer): q and the scale bitwise, outputs within
   1e-6 of scale, kernel, plain and bound times (bound: operations over
   1,979 TOPS or bytes over 3.35 TB/s), Q3 beside torch._int_mm, Q4's one
   pass beside its two launches on the same input. Q1, Q2 and Q3 (on the
   int8 tensor cores) are called as the main path calls them, with their
   max where a quantiser follows, and without: the two outputs must be
   bitwise equal, bitwise their plain versions with the activation none
   or relu (each main-path shape with ELU or the sigmoid is also run with
   none, the pool kept), the max bitwise max |y| and Q4's one pass from
   it bitwise quantize_plain; their device times with and without the
   max, their times beside the kernels they replaced and beside B's or
   U's bf16 kernel on the same layer; ragged Q1, Q2 and Q3 cases off every
   tile edge hold the same. Stage ② of ``apply_r --int8``, traced, must
   launch Q4's kernels 14 times a chunk (Q4_LAUNCHES_A_CHUNK). Then
   ``apply_r --int8`` with phase 4's arguments (Q1-Q4, B, U, C and K must
   launch; phase 4's checks) and its stage seconds beside phase 4's; the
   top-100 recall of the int8 e2e program against the bf16 one on phase
   8's x3 weights, which must read INT8_RECALL (the int8 sums are exact,
   so a different value is a fault); ``export --what e2e --int8 --check``
   at N = 2,560 (its trace at 10,240 alone takes longer than the phase
   should);
11. approximate selection: kernel S (csrc/approx_topk.cu) against its
   plain version, indices and values bitwise, on kernel C's scores of
   seeded bf16 rows at apply_r's two searches (10 needles, 10,000 rows,
   D = 100 and 12,288) and the fused program's needle chunks (256 needles,
   10,240 rows, both D), at recall targets 0.95, 0.99 and 1 (at 1 the values
   must be torch.topk's), and at 256 x 20,480 with r = 1 (large L); S must
   launch one kernel a call at every L (the wrapper's count, and a trace of
   20 calls by tools/time_kernels.py in a fresh process, which also gives
   S's device time); S's wrapper time, its device time, its plain
   version's and torch.topk's times (the same function at r = 1,
   the library call there; the exact selection S stands in for below it)
   and S's bound (4 Q N + 12 Q k bytes over 3.35 TB/s). tiled_topk at
   tiles 512, 1,024 and 2,048
   beside one torch.topk on the pixel chunk's scores (values equal). Then
   phase 4's G3, R and fixer-R with every kernel x 3 (phase 8's other
   weights; the random G ties every score) as checkpoints, ``apply_r``
   with phase 4's arguments, exact and ``--approx --recall_target 0.95``:
   S must launch once per search, phase 4's checks but the score check,
   the latents equal, each returned value the plain score of its index,
   descending, and the top-100 recall of both searches against the exact
   run at least 0.93; stage ④ seconds of both. The fused program on phase
   8's x3 weights with approx=True and pixel_k = 100: S launched 160 times
   in its first call (warm-up and one replay of 2 x 40 chunks) and 80
   kernels in a traced replay, the embeddings equal to the exact
   program's, and the recall of both measures against it at least 0.93;
   img/s of the approximate and exact graphs, with and without the pixel
   measure;
12. the parallel layer (ganreverser_tpu_torch/parallel): (a) a one-rank
   NCCL world on the card (the backend chosen from the topology and
   printed): make_distributed_e2e_program at phase 8's shapes on its x3
   weights, pixel_k 0 and 100, against phase 8's program: embeddings
   within 1e-2 of scale, top-k values within 1e-5, the attribute indices
   equal, and the pixel ring's at every position whose value is unique in
   its row (not the last: a tie with the unseen (k+1)-th); its img/s beside
   phase 8's graph (the collective-wrapping overhead). (b) 2 ranks started
   on the one card (this script with ``--parallel-rank``), which join over
   gloo: the same program at N = 10,240 with the pixel measure (each
   rank's chunk loop a CUDA graph), gathered and held to (a)'s one-rank
   results (values within 1e-5, indices at the positions of unique
   values, both measures); distributed_cosine_topk of 10 needles, exact
   (values within 1e-5 of cosine_topk's, indices as above) and
   approximate on kernel S (recall >= 0.93); kernel B5 with the counter
   base bitwise the rows of the whole mask; one R train step (bf16, batch
   256, --dropout kernel) and one G/D batch pair (bf16, batch 256) on the
   mesh against one rank on the whole batch: the loss relative to itself,
   each leaf's gradients and buffers in the L2 norm relative to the leaf's
   own (the biases that feed a BatchNorm, whose gradient is only rounding,
   relative to the largest gradient), and the share of parameter elements
   stepping more than 10 % of their leaf's largest one-rank step away from
   it; each within 2e-2 (the share 1 %) or twice what bf16 rounding alone
   moves the one-rank step (the one-rank step in f32 on the same weights,
   inputs and masks), a bound that must stay under 0.5 so that a summed
   gradient (1.0) fails; every parameter step within adam's 2 lr; the
   confusion counts equal; stage
   ② of 2,048 rows on a (1, 2) 'model' mesh against one rank (within 1e-2
   of scale, a rank holding part of G). The counters are set to 0 just
   before each mesh-path run and read just after it (the one-rank
   references and B5's bitwise check count nothing); each rank prints
   each run's launches, and the program's run must launch U, U's head, B
   and C, the search C and S, the R step B5 and the invert U and B. (c)
   ``cli.train.main --async_save`` at phase 6's size (2 epochs, then one
   more after --network latest, --noplot) against the same run without it,
   cuDNN held to deterministic algorithms: the checkpoints equal leaf for
   leaf. (d) the host image ops (native/imageops.cc, built with g++)
   against their numpy paths at a realistic batch, with host times;
13. BASELINE.json's configs 1 (y 1x32x32, noise 32; apply_r N = 10,000
   with --batchSize 64, the fused program at batch 64) and 5 (rgb
   3x128x128, noise 256; apply_r N = 2,560 at batch 256 with
   --refine_steps 5, the fused program at batch 128), random weights from
   the seed (CONFIGS): (a) at each config's shapes, B, U, U's head (C = the
   config's channels) and C against their plain versions at phase 3's
   tolerances (f32 and bf16, timed in bf16), K's whole run as phase 3
   holds it, Q1-Q4 bitwise as phase 10 holds them (no trace: their device
   times are phase 10's), Q3 at R l27 with every operand +-127 (at config
   5, K = 131,072: sums of 2,114,060,288), S bitwise at apply_r's and the
   e2e chunks' searches (r 0.95 and 1), D at G l0, R l27 and R l31 within
   phase 3's dense_close; (b) ``cli.apply_r.main`` with the
   fixer-R in bf16, then --int8 and --approx on the same checkpoints,
   each counted and held to phase 4's checks (the searches against the
   scores in f64), S once per search, the recalls of --int8 and --approx
   against bf16 printed (no gate); fast vs plain in f32 on 512 rows, and
   the refinement of 512 of the images from R's latents (5 adam steps): no
   image's loss may rise; (c) the fused program at N = 10,240, pixel_k 0
   and 100: first calls counted with their peak device memory, a replay
   adding exactly the chunks' launches and bitwise the first call, the
   top-k as phase 8 holds it, img/s of warm calls. Every kernel of the
   paths (B, U, U's head, C, K, Q1-Q4, S, D) must launch at each config,
   and a line per kernel gives its summed times, bound and launches there.
   ``python3 chip_smoke.py --configs`` runs phases 1, 2 and 13 alone (no
   result lines).

The last two lines are a JSON object with each kernel's route, source,
launch count in the main path (Q1-Q4's: ``apply_r --int8`` and the int8
e2e export's check; S's: phase 11's ``apply_r --approx`` and approximate
fused program; phase 12's distributed paths add theirs to U's, the
head's, B's, C's, S's and B5's; phase 13's configs' paths add theirs to
B's, U's, the head's, C's, K's, Q1-Q4's, S's and D's; the FIR filter's: one
forward and backward of config F), error, times and bound
(phases 3, 10 and 11, at 3x64x64; the FIR filter's at config F), and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when CUDA is absent or the package is not
beside this file.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

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
# B8 vs kernel U (the probe's): U rounds its phase kernels from the rounded
# kernel, B8 sums them in f32 and rounds once
TOL_V2_U = {"float32": 1e-4, "bfloat16": 3e-2}
KMEANS_K, KMEANS_ITERS = 20, 15   # apply_r.lua:158
KMEANS_K_WIDE = 256    # apply_r --clusters 256
REFINE_STEPS = 5
DROPOUT_SHAPES = [(256, 64, 64, 64), (256, 512), (256, 64, 64, 3)]
DROPOUT_SEEDS = [12345, -7]
# the element dropouts of one R step at batch 256, 64x64, in layer order
# (after blocks 1 and 2, after the first pool, after blocks 4 and 5, after
# the dense layer): their summed time is the kernels line's B5 entry
DROPOUT_STEP_SHAPES = [(256, 64, 64, 64), (256, 64, 64, 64),
                       (256, 32, 32, 64), (256, 32, 32, 128),
                       (256, 32, 32, 128), (256, 512)]
# StyleGAN2's FIR filter at one refine step of sg2f_ffhq1024.refine_sg2:
# config F as the benchmark's file states it, the cell's chunk of 8
SG2F_CONFIG = "portbench/configs/sg2f_ffhq1024.json"
FIR_BATCH = 8
FIR_TOL = 1e-5           # of the largest output: the f32 sums' order
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
# phase 8, bench.py's e2e program: N and batch (bench.py:107-108), and
# apply_r's batch; k, the needle chunk and the pixel measure's k
E2E_N = 10_240
E2E_BATCHES = (128, 256)
E2E_K, E2E_CHUNK, E2E_PIXEL_K = 100, 256, 100
E2E_TIMES = 5            # graph calls timed
E2E_AMPLIFY = 3.0        # the second G's and R's kernels, phase 4's x 3
TOL_TOPK = 1e-5          # e2e top-k vs the plain search (pixels: f64)
# kernel D's two products, unsplit and under a K split: HGMMA in every
# instance (BN 16 to 256); its sum kernel, on the CUDA cores: none
DENSE_WGMMA = ("dense_bf16_wgmma_kernel", "dense_bf16_split_wgmma_kernel")
DENSE_SUM = "dense_bf16_sum_kernel"
# each e2e wrapper's kernel, by the name a torch.profiler trace gives it
# (one per counted launch; the bf16 kernels; kernel D's product, split or
# not)
E2E_DEVICE_KERNELS = {"upsample2_conv3x3_bn_act": "upsample2_wgmma_kernel",
                      "upsample2_conv3x3_head": "upsample2_head_wgmma_kernel",
                      "conv_block": "conv3x3_wgmma_kernel",
                      "cosine_scores": "cosine_wgmma_kernel",
                      "dense_act": DENSE_WGMMA}
CONVBN_SHAPE = (256, 64, 64, 256, 128)   # B7's probe: N, H, W, Ci, Co
PRETRAIN_BATCH = 128     # pretrain_g's default --batchSize
PRETRAIN_EPOCH_BATCHES = 10   # --N_epoch of phase 7 (depth; the default 30)
DISTILL_BATCH = 64
# pretrain_prev legs from phase 6's rgb 3x64x64 checkpoint: new colour
# space, height = width, noise dim, batches
DISTILL_LEGS = [("yuv", 64, NOISE_DIM, 60), ("y", 32, 50, 20)]


def fir_cases(cfg: dict):
    """(label, up, input shape, input dtype) of one config-F forward's 16
    filters: at each resolution r from 8 up, the blur after the
    up-sampling convolution (its f32 output, (r + 1)^2 -> r^2, the block's
    channels) and the skip's up-sampling of the bf16 image ((r / 2)^2 ->
    r^2, 3 channels)."""
    _, top, _ = cfg["image"]
    r = 8
    while r <= top:
        ch = min(2 * cfg["channel_base"] // r, cfg["channel_max"])
        yield f"blur{r}", 1, (FIR_BATCH, r + 1, r + 1, ch), "float32"
        yield f"skip{r}", 2, (FIR_BATCH, r // 2, r // 2, 3), "bfloat16"
        r *= 2


def fir_close(out, ref, rounded: bool) -> tuple:
    """(max |out - ref|, within tolerance): FIR_TOL of ref's largest
    element, plus one bf16 step (2^-7 of the value) where both summed in
    f32 and then rounded to bf16, and may land on neighbouring values."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    allowed = FIR_TOL * ref.abs().max().item() + (
        2.0 ** -7 * ref.abs() if rounded else 0.0)
    return err.max().item(), bool((err <= allowed).all())


def fir_library(x, up: int, dtype):
    """The module path's filter before the kernel: x rounded to ``dtype``
    and widened, then cuDNN's depthwise F.conv2d (the blur) or stride-2
    F.conv_transpose2d (the skip) of f32 operands, at the precision the
    module path pinned."""
    import torch.nn.functional as F
    from ganreverser_tpu_torch.core.precision import pinned_precision
    from ganreverser_tpu_torch.ops import fir_kernel as fk
    c = x.shape[3]
    xt = x.to(dtype).float().permute(0, 3, 1, 2)
    taps = fk.fir_taps(c, x.device)   # symmetric: the flip changes nothing
    with pinned_precision(dtype):
        if up == 2:
            y = F.conv_transpose2d(xt, taps, stride=2, padding=1, groups=c)
        else:
            y = F.conv2d(xt, taps, padding=1, groups=c)
    return y.permute(0, 2, 3, 1)


def fir_step_launches(dev, cfg: dict, dtype) -> int:
    """The filter's launches in one forward and backward of config F at
    FIR_BATCH (random weights drawn as the benchmark draws them, z the
    only leaf that needs a gradient), its counter set to 0 just before;
    the wrapper must copy no input."""
    import torch
    from ganreverser_tpu_torch.models import modules, zoo
    from ganreverser_tpu_torch.ops import fir_kernel as fk
    from portbench import reference_sg2
    with torch.device(dev):
        G = zoo.create_G_sg2f(cfg["image"], cfg["noise_dim"], cfg["w_dim"],
                              dtype, mapping_layers=cfg["mapping_layers"],
                              channel_base=cfg["channel_base"],
                              channel_max=cfg["channel_max"])
    G.load_state_dict(reference_sg2.make(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 24), dev))
    G.requires_grad_(False)
    firs = sum(isinstance(m, modules.FIRFilter) for m in G.modules())
    z = torch.randn(FIR_BATCH, cfg["noise_dim"], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED),
                    requires_grad=True)
    fk.fir_filter.launches = fk.fir_filter.copies = 0
    G(z).float().square().mean().backward()
    torch.cuda.synchronize()
    launches, copies = fk.fir_filter.launches, fk.fir_filter.copies
    check(launches == 2 * firs, f"fir_filter: {launches} launches in one "
          f"forward and backward of config F, not 2 x its {firs} filters")
    check(copies == 0, f"fir_filter copied {copies} inputs in config F")
    check(bool(torch.isfinite(z.grad).all()), "config F: z's gradient is "
          "not finite")
    return launches


def check_fir(dev, card: str):
    """Phase 3, StyleGAN2's FIR filter (csrc/fir.cu) at the 16 shapes of
    one config-F refine step, batch 8, bf16 compute dtype: forward and
    backward through fir_filter against upfirdn2d_plain's forward and
    gradient forms (FIR_TOL, one bf16 step more for the rounded
    gradient); the wrapper's, plain, library (fir_library, its backward
    by autograd) and bound times of each; then the launches of one
    forward and backward of config F. Returns one record, a step's 16
    filters forward and backward, and those launches."""
    import torch
    from ganreverser_tpu_torch.ops import fir_kernel as fk
    from portbench import reference_sg2
    with open(SG2F_CONFIG) as f:
        cfg = reference_sg2.config(json.load(f))
    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    err, sums = 0.0, [0.0] * 4
    for label, up, shape, xname in fir_cases(cfg):
        fwd, grad_form = fk.FORMS[up]
        x = torch.randn(shape, device=dev, generator=gen).to(
            getattr(torch, xname))
        xg = x.clone().requires_grad_(True)
        y = fk.fir_filter(xg, up, dtype)
        dy = torch.randn(y.shape, device=dev, generator=gen)
        (dx,) = torch.autograd.grad(y, xg, dy)
        torch.cuda.synchronize()
        check(dx.dtype == x.dtype and y.dtype == torch.float32,
              f"fir_filter {label}: dtypes {y.dtype}, {dx.dtype}")
        e_y, ok_y = fir_close(y, fk.upfirdn2d_plain(x, fwd, dtype), False)
        e_dx, ok_dx = fir_close(dx, fk.upfirdn2d_plain(
            dy, grad_form, torch.float32, dtype, x.dtype), True)
        check(ok_y and ok_dx, f"fir_filter {label} {shape}: kernel vs plain "
              f"forward {e_y}, backward {e_dx}, beyond the tolerance")
        err = max(err, e_y, e_dx)
        del xg, y, dx
        xl = x.clone().requires_grad_(True)
        yl = fir_library(xl, up, dtype)
        row = []
        # each launch reads its input once and writes its output once; 16
        # multiply-adds an output (zero-inserted taps counted too) take far
        # less than those bytes
        for kern, plain, library, outputs in (
                (lambda: fk.fir_filter(x, up, dtype),
                 lambda: fk.upfirdn2d_plain(x, fwd, dtype),
                 lambda: fir_library(x, up, dtype), dy.numel()),
                (lambda: fk.upfirdn2d(dy, grad_form, torch.float32, dtype,
                                      x.dtype),
                 lambda: fk.upfirdn2d_plain(dy, grad_form, torch.float32,
                                            dtype, x.dtype),
                 lambda: torch.autograd.grad(yl, xl, dy, retain_graph=True),
                 x.numel())):
            b_ms, _ = bound(32 * outputs, _nbytes(dy, x), "float32")
            row += [time_ms(kern), time_ms(plain), time_ms(library), b_ms]
        del xl, yl, x, dy
        sums = [a + b for a, b in zip(sums, [row[i] + row[i + 4]
                                             for i in range(4)])]
        print(f"[kernel] fir_filter {label} {shape} {xname} in, bf16: "
              f"forward err {e_y:.3e}, backward err {e_dx:.3e}; forward "
              f"kernel {row[0]:.4f} ms, plain {row[1]:.4f}, library "
              f"{row[2]:.4f}, bound {row[3]:.4f}; backward kernel "
              f"{row[4]:.4f} ms, plain {row[5]:.4f}, library {row[6]:.4f}, "
              f"bound {row[7]:.4f}  [{card}]")
    launches = fir_step_launches(dev, cfg, dtype)
    ms, plain_ms, lib_ms, b_ms = sums
    print(f"[kernel] fir_filter, one config-F refine step's 16 filters "
          f"(b{FIR_BATCH} bf16), forward + backward: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (cuDNN depthwise) "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms (bytes); {launches} "
          f"launches in one forward and backward of config F  [{card}]")
    return {"name": "fir_filter", "label": "one config-F step's 16 filters",
            "dtype": "bfloat16", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": "bytes"}, launches


def dense_layers(dims, noise_dim: int) -> list:
    """Kernel D's shapes in the fused program at ``dims`` and ``noise_dim``:
    G l0, R l27 and R l31 (normal noise) as (label, K, M, act)."""
    _, h, w = dims
    pix = (h // 4) * (w // 4)
    return [(f"G l0 {h}x{w}", noise_dim, 512 * pix, "relu"),
            (f"R l27 {h}x{w}", 128 * pix, 512, "elu"),
            (f"R l31 {h}x{w}", 512, noise_dim, "none")]


# kernel D's rows of phase 3: every shape the fused program gives it at
# 3x64x64 z 100 and 3x128x128 z 256, batch 128 (R l31 unsplit at BN 16, its
# last column tile partial at z 100)
DENSE_LAYERS = dense_layers((3, 64, 64), 100) + dense_layers((3, 128, 128),
                                                              256)
DENSE_BATCH = 128


def dense_close(out, ref, x, w) -> float:
    """Kernel D's output against its plain version's, both bf16: the
    worst error in units of one bf16 step of the larger of the two values
    plus 2^-14 of that output's sum of |x * w|; at most 1 passes. Both
    sum the same exact f32 products of bf16 operands in f32, in other
    orders (the tensor cores', cuBLAS's); each order's error is some
    sqrt(K) f32 rounding errors of that sum, under 2^-15 of it at K =
    131,072, which moves the f32 value across a bf16 rounding boundary at
    most once or, where the sum nearly cancels, by a few of its own small
    bf16 steps."""
    import torch
    o, r = out.float(), ref.float()
    big = torch.maximum(o.abs(), r.abs())
    step = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(big)) - 7),
                       torch.zeros_like(big))
    mag = (x.to(torch.bfloat16).float().abs()
           @ w.to(torch.bfloat16).float().abs())
    return ((o - r).abs() / (step + mag * 2.0 ** -14)).max().item()


def check_dense(dev, card: str, layers=DENSE_LAYERS,
                tag: str = "kernel") -> list:
    """Phase 3 (and phase 13 at a config's ``dense_layers``, lines tagged
    ``tag``), kernel D (csrc/dense.cu) at ``layers``, bf16: against its
    plain version on the card within dense_close; the wrapper's ms, its
    device ms (the product, and the sum kernel under a K split), the
    plain version's ms (the f32 product of the rounded kernel and its
    three passes, what the fast forwards ran before), the library's (the
    tensor cores' bf16 product with an f32 output,
    ``torch.mm(..., out_dtype=torch.float32)``, and the same passes) and
    the bound: the weights, x and the output once each over the memory
    rate, or the operations over the bf16 peak. Returns one record a
    layer."""
    import torch
    from ganreverser_tpu_torch.ops import dense_kernel as D
    bf16 = torch.bfloat16
    records = []
    for label, k, m, act in layers:
        gen = torch.Generator(device=dev).manual_seed(SEED + 26 + k % 1000)
        x = torch.randn(DENSE_BATCH, k, device=dev, generator=gen).to(bf16)
        w = torch.randn(k, m, device=dev, generator=gen) / math.sqrt(k)
        shift = 0.1 * torch.randn(m, device=dev, generator=gen)
        op = D.dense_operand(w)
        k32 = D.operand_kernel(op, k)
        wt = op[:, :k].T

        def kern():
            return D.dense_act(x, op, shift, act)

        def plain():
            return D.dense_act_plain(x, k32, shift, act)

        def library():
            return D.activation(torch.mm(x, wt, out_dtype=torch.float32)
                                + shift, act).to(bf16)
        out = kern()
        torch.cuda.synchronize()
        ratio = dense_close(out, plain(), x, w)
        lib_ratio = dense_close(library(), plain(), x, w)
        check(ratio <= 1.0, f"dense_act {label}: error {ratio} of the "
              "tolerance (one bf16 step + 2^-14 of the sum of |x w|)")
        plan, splits = D.dense_plan(DENSE_BATCH, k, m)
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(library)
        dev_ms = launch_ms(kern, (*DENSE_WGMMA, DENSE_SUM))
        b_ms, b_by = bound(2.0 * DENSE_BATCH * k * m,
                           _nbytes(op, x, out), "bfloat16")
        print(f"[{tag}] dense_act {label} ({DENSE_BATCH},{k})x({k},{m}) "
              f"bf16 {act}, plan {tuple(plan)} splits {splits}: error "
              f"{ratio:.3f} of the tolerance (the library's {lib_ratio:.3f}),"
              f" kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (torch.mm bf16 -> "
              f"f32 + its passes), bound {b_ms:.4f} ms ({b_by})  [{card}]")
        records.append({"name": "dense_act", "label": label,
                        "dtype": "bfloat16", "max_abs_err": (
                            out.float() - plain().float()).abs().max().item(),
                        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": b_ms,
                        "bound_by": b_by})
        del x, w, op, k32, wt, out
        torch.cuda.empty_cache()
    return records


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


# the bf16 tensor-core kernels: each must hold HGMMA in every instance
WGMMA_KERNELS = ("conv3x3_wgmma_kernel", "upsample2_wgmma_kernel",
                 "conv_stats_wgmma_kernel", "upsample_v2_wgmma_kernel",
                 "upsample2_head_wgmma_kernel", "cosine_wgmma_kernel")
HEAD_WGMMA = "upsample2_head_wgmma_kernel"   # built for BN up to 128 only
# their HGMMA instructions per instance, as built before Q1 and Q2 moved
# onto the same mainloop (every instance but the head's: one count for all
# widths)
HGMMA_COUNTS = {"conv3x3_wgmma_kernel": 8, "upsample2_wgmma_kernel": 8,
                "conv_stats_wgmma_kernel": 8, "upsample_v2_wgmma_kernel": 8,
                "cosine_wgmma_kernel": 4,
                HEAD_WGMMA: {16: 12, 32: 15, 64: 21, 128: 33}}
# Q1's, Q2's and Q3's kernels on the int8 tensor cores: IGMMA in every
# instance
S8_KERNELS = ("quant_conv3x3_s8_kernel", "quant_upsample2_s8_kernel",
              "quant_dense_s8_kernel", "quant_dense_split_s8_kernel")
# Q3's split-K sum and Q4's kernels, streaming passes on the CUDA cores: no
# tensor-core instruction
INT8_CUDA_CORE_KERNELS = ("quant_dense_sum_kernel", "quant_absmax_kernel",
                          "quant_apply_kernel", "quant_apply_max_kernel")
# Q4's device kernels: the two launches of an entry quantiser, the one
# pass after an int8 producer
Q4_KERNELS = {"absmax": "quant_absmax_kernel", "apply": "quant_apply_kernel",
              "one pass": "quant_apply_max_kernel"}
# the bf16 kernels whose second launch adds partials: a second call must be
# bitwise the first
REPEATABLE = ("upsample2_conv3x3_head", "cosine_scores")
# the main path's tensor-core layers (label, H, W, Ci, Co at the input's
# resolution), whose tile plans phase 2 prints
MAIN_CONV_LAYERS = [("R block 1 l0", 64, 64, 3, 64),
                    ("R block 1 l1-2", 64, 64, 64, 64),
                    ("R block 2 l0", 32, 32, 64, 128),
                    ("R block 2 l1-2", 32, 32, 128, 128),
                    ("G stage 1", 16, 16, 512, 256),
                    ("G stage 2", 32, 32, 256, 128)]


def sass_hgmma(lib_path, opcode: str = "HGMMA") -> dict:
    """``opcode`` instructions (by default HGMMA, the tensor cores') per
    kernel function in the SASS of the built library (cuobjdump -sass), by
    mangled name."""
    from ganreverser_tpu_torch.ops import cuda_lib
    proc = subprocess.run([cuda_lib.cuda_tool("cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr[-2000:]}")
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def _instances(counts: dict, stem: str) -> dict:
    """``counts`` of the instances of the kernel template ``stem``, by BN
    (the template argument of the mangled name)."""
    return {int(re.search(r"ILi(\d+)E", n).group(1)): c
            for n, c in counts.items() if re.search(rf"\d{stem}I", n)}


def check_hgmma(lib_path) -> dict:
    """The SASS guard: every instance of the bf16 kernels (one per tile
    width BN) holds as many HGMMA instructions as HGMMA_COUNTS says, and
    every instance of kernel D's two some; every instance of Q1's, Q2's
    and Q3's s8 kernels holds IGMMA, Q3's and D's sum kernels and Q4's
    kernels neither, and no kernel DP4A (the CUDA cores' int8 product,
    which Q3 ran on before). Returns the counts by kernel and BN."""
    from ganreverser_tpu_torch.ops.conv_operands import HEAD_MAX_BN, WIDTHS_N
    hgmma, igmma = sass_hgmma(lib_path), sass_hgmma(lib_path, "IGMMA")
    found = {}
    for stem in WGMMA_KERNELS:
        widths = tuple(b for b in WIDTHS_N
                       if stem != HEAD_WGMMA or b <= HEAD_MAX_BN)
        mine = _instances(hgmma, stem)
        want = HGMMA_COUNTS[stem]
        want = {b: want if isinstance(want, int) else want[b]
                for b in widths}
        check(mine == want, f"SASS: HGMMA per instance of {stem} {mine}, "
              f"expected {want}")
        found[stem] = mine
    for stem in DENSE_WGMMA:
        mine = _instances(hgmma, stem)
        check(sorted(mine) == list(WIDTHS_N) and all(mine.values()),
              f"SASS: HGMMA per instance of {stem} {mine}, expected some in "
              f"one instance per BN in {WIDTHS_N}")
        found[stem] = mine
    for stem in S8_KERNELS:
        mine = _instances(igmma, stem)
        check(sorted(mine) == list(WIDTHS_N) and all(mine.values()),
              f"SASS: IGMMA per instance of {stem} {mine}, expected some in "
              f"one instance per BN in {WIDTHS_N}")
        found[stem] = mine
    for stem in (*INT8_CUDA_CORE_KERNELS, DENSE_SUM):
        names = [n for n in hgmma if re.search(rf"\d{stem}E", n)]
        check(len(names) == 1 and not hgmma[names[0]]
              and not igmma[names[0]], f"SASS: {stem} ({names}) is not one "
              "kernel free of tensor-core instructions")
    dp4a = {n: c for n, c in sass_hgmma(lib_path, "DP4A").items() if c}
    check(not dp4a, f"SASS: DP4A in {dp4a}")
    return found


def ptxas_lines(log: str) -> list:
    """One line per kernel from a build log with -Xptxas -v: its mangled
    name, registers, barriers, stack and spill bytes."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


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


def device_ms(fn, names, reps: int = 10) -> float:
    """Device time per call of ``fn`` in the kernels whose name holds one
    of ``names``, from a torch.profiler trace of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
                for ev in prof.key_averages()
                if any(n in ev.key for n in names))
    return total / reps / 1e3


def launch_ms(fn, names, reps: int = 10, tries: int = 3) -> float:
    """Device time per call of ``fn`` that launches each kernel whose name
    holds one of ``names`` once: the mean time per recorded launch of each
    such kernel, summed, from a torch.profiler trace of ``reps`` calls,
    traced again (up to ``tries`` times) while it records none. Late in
    this script's run, a phase-10 trace now and then recorded a fifth of a
    kernel's launches, or none; these means do not depend on how many."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.count and any(n in ev.key for n in names)]
        if events:
            return sum(getattr(ev, "device_time_total",
                               getattr(ev, "cuda_time_total", 0.0))
                       / ev.count for ev in events) / 1e3
    check(False, f"no launch of {names} in {tries} traces")
    return 0.0


def device_counts(fn, names: dict) -> dict:
    """Per key of ``names``, the device kernels of one call of ``fn`` whose
    name holds its value (or one of a tuple of them), counted in a
    torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {key: sum(ev.count for ev in events
                     if any(n in ev.key for n in ((name,) if isinstance(
                         name, str) else name)))
            for key, name in names.items()}


# the card's published peaks (H100 SXM, dense) that the benchmark's
# portbench/work.py has no use for: f32 on the CUDA cores, int8
PEAK_F32_FLOPS, PEAK_INT8_OPS = 67e12, 1979e12


def bound(flops: float, nbytes: float, dtype: str):
    """(ms, "operations" or "bytes"): the larger of the operations over the
    peak rate of the inputs' type and the bytes over the memory rate (the
    bf16 peak and the memory rate are portbench/work.py's)."""
    from portbench.work import MEM_BYTES_PER_S, PEAK_FLOPS
    peak = {"bfloat16": PEAK_FLOPS, "float32": PEAK_F32_FLOPS,
            "int8": PEAK_INT8_OPS}[dtype]
    t_ops = flops / peak * 1e3
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


def kernel_cases(dev, n: int, n_search: int, dims=DIMS,
                 noise_dim: int = NOISE_DIM, names=None):
    """(kernel, label, make(dtype) -> case) at the main path's shapes (G3
    and R at ``dims``, latents of ``noise_dim``), only of the kernels in
    ``names`` where it is given; a case holds the kernel's call, its plain
    version, the library call that computes the same function (None where
    PyTorch has none), and the operations and bytes of the function on
    these inputs."""
    import torch
    import torch.nn.functional as F
    from ganreverser_tpu_torch.ops import (conv_block_kernel as cb,
                                           conv_kernel as ck,
                                           topk_kernel as tk,
                                           upsample_conv_kernel as uc,
                                           upsample_v2_kernel as v2)
    from ganreverser_tpu_torch.ops.upsample_conv import conv_nhwc
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c, h, w = dims
    cases = []

    def wanted(name):
        return names is None or name in names

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

            def unfused():  # U, then the head as a separate conv (reference)
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
                    "u": lambda: uc.upsample2_conv3x3_bn_act(x, k, sc, sh,
                                                             act="relu"),
                    "flops": 2 * nb * (2 * hh) * (2 * ww) * 4 * ci * co,
                    "bytes": (_nbytes(x, k, sc, sh)
                              + nb * 4 * hh * ww * co * x.element_size())}
        cases.append(("upsample_v2", label, make))

    def search(label, d, positive, rows=n_search, needles=None):
        """C with apply_r's NEEDLES needles, or with ``needles`` (the
        fused e2e program's needle chunk: rows 0 .. 255)."""
        e0 = torch.randn(rows, d, device=dev, generator=gen)
        if positive:  # pixels are sigmoid outputs in [0, 1]
            e0 = torch.sigmoid(e0)
        idx = (torch.tensor([(i + 1) * 100 - 1 for i in range(NEEDLES)],
                            device=dev) if needles is None
               else torch.arange(needles, device=dev))
        q = idx.shape[0]
        en = e0 / e0.norm(dim=1, keepdim=True)
        qn = en[idx]

        def make(dtype):
            e = e0.to(dtype)
            return {"kernel": lambda: tk.cosine_scores(e, idx),
                    "plain": lambda: tk.cosine_scores_plain(e, idx),
                    # one product of rows normalised beforehand
                    "library": lambda: torch.matmul(qn, en.T),
                    "flops": 2 * q * rows * d + 2 * rows * d,
                    "bytes": _nbytes(e, idx) + q * rows * 4}
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

    if wanted("conv_block"):
        block(f"R block 1 ({n},{h},{w},{c})->64x3+pool", (n, h, w, c),
              [c, 64, 64, 64])
        block(f"R block 2 ({n},{h // 2},{w // 2},64)->128x3+pool",
              (n, h // 2, w // 2, 64), [64, 128, 128, 128])
    if wanted("upsample2_conv3x3_bn_act"):
        upsample(f"G stage 1 ({n},{h // 4},{w // 4},512)->256",
                 (n, h // 4, w // 4, 512), 256)
        upsample(f"G stage 2 ({n},{h // 2},{w // 2},256)->128",
                 (n, h // 2, w // 2, 256), 128)
    if wanted("cosine_scores"):
        search(f"attributes ({n_search},{noise_dim}) x {NEEDLES}", noise_dim,
               False)
        search(f"pixels ({n_search},{c * h * w}) x {NEEDLES}", c * h * w,
               True)
        # the fused e2e program's needle chunks (phase 8)
        search(f"attributes ({E2E_N},{noise_dim}) x {E2E_CHUNK}", noise_dim,
               False, E2E_N, E2E_CHUNK)
        search(f"pixels ({E2E_N},{c * h * w}) x {E2E_CHUNK}", c * h * w,
               True, E2E_N, E2E_CHUNK)
    # D2's five conv + PReLU layers (stem l0, l1+pool; right branch
    # l0+pool, l2, l3+pool), one with a negative slope
    if wanted("conv3x3_bn_act"):
        for label, shape, co, alpha, pool in D2_B6_LAYERS:
            conv_prelu(label, (n,) + shape, co, alpha, pool)
    # U's fused head at G3's stage 2: C = 3 (pretrain_prev's G_prev), and
    # C = 1 (a grayscale G_prev); with ``names`` only the path's C
    if wanted("upsample2_conv3x3_head"):
        for cf in (3, 1) if names is None else (c,):
            head(f"G stage 2 + head ({n},{h // 2},{w // 2},256)->128->{cf}",
                 (n, h // 2, w // 2, 256), 128, cf, cf == c)
    if wanted("upsample_v2"):
        upsample_v2(f"G stage 1 ({n},{h // 4},{w // 4},512)->256",
                    (n, h // 4, w // 4, 512), 256)
        upsample_v2(f"G stage 2 ({n},{h // 2},{w // 2},256)->128",
                    (n, h // 2, w // 2, 256), 128)
    return cases


def check_kernels(dev, card: str, n: int = N_CHECK, n_search: int = N_MAIN,
                  dims=DIMS, noise_dim: int = NOISE_DIM, names=None,
                  timed=("float32", "bfloat16"), tag: str = "kernel"):
    """Phase 3 (and phase 13 at another ``dims``, ``noise_dim`` and
    ``n_search``, the kernels of ``names``): every kernel against its plain
    version in f32 and bf16; returns one record per (kernel, shape, dtype)
    with the times of the kernel, its plain version and the library call,
    and the kernel's bound, timed in the dtypes of ``timed`` (the others
    are checked only)."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    records = []
    for name, label, make in kernel_cases(dev, n, n_search, dims, noise_dim,
                                          names):
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
            repeat = ""
            if name in REPEATABLE and dtype == torch.bfloat16:
                check(torch.equal(kern(), out), f"{name} {label} {dname}: a "
                      "second call differs from the first")
                repeat = ", a second call bitwise equal"
            tol = (TOL_SCORES if name == "cosine_scores"
                   else TOL[dname] * scale)
            versus = ""
            if "u" in case:  # B8 against kernel U on the same inputs
                err_u = (out.float() - case["u"]().float()).abs().max().item()
                tol_u = TOL_V2_U[dname] * scale
                versus = (f", vs kernel U max_abs_err {err_u:.3e} (tol "
                          f"{tol_u:.1e}), U {time_ms(case['u']):.4f} ms")
                check(err_u <= tol_u, f"{name} {label} {dname}: vs kernel U "
                      f"{err_u} > {tol_u}")
            del out, ref
            check(err <= tol, f"{name} {label} {dname}: max_abs_err {err} "
                  f"> tol {tol}")
            if dname not in timed:
                print(f"[{tag}] {name} {label} {dname}: max_abs_err "
                      f"{err:.3e} (tol {tol:.1e}){repeat}{versus}  [{card}]")
                continue
            ms, plain_ms = time_ms(kern), time_ms(plain)
            lib_ms = time_ms(case["library"])
            b_ms, b_by = bound(case["flops"], case["bytes"], dname)
            unfused = (f", unfused U + head {time_ms(case['unfused']):.4f} ms"
                       if "unfused" in case else "")
            print(f"[{tag}] {name} {label} {dname}: max_abs_err {err:.3e} "
                  f"(tol {tol:.1e}){repeat}, kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}){unfused}{versus}  [{card}]")
            records.append({"name": name, "label": label, "dtype": dname,
                            "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "on_path": case.get("on_path", True)})
    return records


def _step_against_plain(what, x, c, new_c, counts, sums, assign):
    """One Lloyd step of kernel K (its outputs from centroids ``c``)
    against the plain step on ``c``: the assignment wherever the plain
    margin exceeds 1e-4 of max |d|, the counts those of the kernel's
    assignment, the sums the plain sums over it (TOL_SUMS relative) and
    the centroids sums / counts. Returns (max sums error, its tolerance,
    rows assigned otherwise than by the plain step)."""
    import torch
    from ganreverser_tpu_torch.ops import kmeans_kernel as kk
    _, _, _, ref_assign = kk.kmeans_step_plain(x, c, details=True)
    d = (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)
    top2 = torch.topk(d, min(2, c.shape[0]), dim=1, largest=False).values
    sure = ((top2[:, -1] - top2[:, 0]) > 1e-4 * d.abs().max()
            if c.shape[0] > 1 else torch.ones_like(ref_assign, dtype=bool))
    flipped = int((assign != ref_assign).sum())
    check(torch.equal(assign[sure], ref_assign[sure]),
          f"{what}: assignment differs from plain beyond the margin")
    k = c.shape[0]
    check(torch.equal(counts, torch.bincount(assign, minlength=k).float()),
          f"{what}: counts are not those of its assignment")
    ref_sums = torch.nn.functional.one_hot(assign, k).float().T @ x
    err = (sums - ref_sums).abs().max().item()
    tol = TOL_SUMS * max(1.0, ref_sums.abs().max().item())
    check(err <= tol, f"{what}: sums differ from plain by {err} > {tol}")
    ref_new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp_min(counts, 1.0)[:, None], c)
    check(torch.equal(new_c, ref_new),
          f"{what}: centroids are not sums / counts")
    seg_sums, _ = kk.kmeans_segment_sums_plain(x, assign, k)
    check(torch.equal(sums, seg_sums),
          f"{what}: sums are not bitwise the segment order's "
          f"(kmeans_segment_sums_plain)")
    return err, tol, flipped


def kmeans_case(x, c):
    """One Lloyd step of kernel K (``kmeans_step``) against its plain
    version on the same centroids, and bitwise equal over two runs.
    Returns (max |kernel sums - plain sums over the kernel's assignment|,
    its tolerance, rows whose assignment differs from the plain one)."""
    import torch
    from ganreverser_tpu_torch.ops import kmeans_kernel as kk
    out = kk.kmeans_step(x, c, details=True)
    torch.cuda.synchronize()
    again = kk.kmeans_step(x, c, details=True)
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "kmeans_step: two runs differ")
    return _step_against_plain("kmeans_step", x, c, *out)


def lloyd_case(x, c, iters: int):
    """Kernel K's whole run (``kmeans_lloyd``, one launch): bitwise equal
    over two runs; each iteration (the run of i iterations, whose first
    i - 1 are the longer run's) held against the plain step from the
    kernel's centroids before it, as ``kmeans_case`` holds one step; and,
    when no near-tie row went otherwise in any iteration, the final
    centroids within TOL_SUMS of the plain run (``kmeans_lloyd_plain``)
    and the counts equal. Returns (max sums error, its tolerance, rows
    assigned otherwise summed over the iterations, max |kernel - plain
    run| of the centroids)."""
    import torch
    from ganreverser_tpu_torch.ops import kmeans_kernel as kk
    out = kk.kmeans_lloyd(x, c, iters, details=True)
    torch.cuda.synchronize()
    again = kk.kmeans_lloyd(x, c, iters, details=True)
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "kmeans_lloyd: two runs differ")
    cur, err, tol, flipped = c.float(), 0.0, 0.0, 0
    for i in range(1, iters + 1):
        step = out if i == iters else kk.kmeans_lloyd(x, c, i, details=True)
        e, t, f = _step_against_plain(f"kmeans_lloyd iteration {i}", x, cur,
                                      *step)
        err, tol, flipped = max(err, e), max(tol, t), flipped + f
        cur = step[0]
    plain_c, plain_counts = kk.kmeans_lloyd_plain(x, c, iters)
    run_err = (out[0] - plain_c).abs().max().item()
    if flipped == 0:
        check(torch.equal(out[1], plain_counts) and run_err <= TOL_SUMS * max(
            1.0, plain_c.abs().max().item()),
              f"kmeans_lloyd: {run_err} from the plain run with no near-tie "
              f"row assigned otherwise")
    return err, tol, flipped, run_err


def check_kmeans(dev, card: str, n: int = N_MAIN):
    """Phase 3, kernel K: one step and the whole run of KMEANS_ITERS
    iterations at the main path's shape, at K = 256 and at a ragged N with
    an empty cluster; the run's wrapper and device times beside one step's.
    Returns one record (the whole run at K = 20)."""
    import torch
    from ganreverser_tpu_torch.ops import kmeans_kernel as kk
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn(n, NOISE_DIM, device=dev, generator=gen)
    c = x[torch.randperm(n, device=dev, generator=gen)[:KMEANS_K]]
    err, tol, flipped = kmeans_case(x, c)
    step_ms = time_ms(lambda: kk.kmeans_step(x, c))
    step_dev = device_ms(lambda: kk.kmeans_step(x, c), ("kmeans",))
    print(f"[kernel] kmeans_step ({n},{NOISE_DIM}) K={KMEANS_K} float32: "
          f"sums max_abs_err {err:.3e} (tol {tol:.1e}), {flipped} near-tie "
          f"rows assigned otherwise, one step {step_ms:.4f} ms, device "
          f"{step_dev:.4f} ms  [{card}]")
    cases = {}
    # apply_r --clusters 256 at noise 100: the centroids stream past the
    # rows in four tiles of 64 (ops/kmeans_kernel.py::kmeans_plan)
    c256 = x[torch.randperm(n, device=dev, generator=gen)[:KMEANS_K_WIDE]]
    for kc in (c, c256):
        k = kc.shape[0]
        err_k, tol_k, flipped_k, run_err = lloyd_case(x, kc, KMEANS_ITERS)
        run = lambda: kk.kmeans_lloyd(x, kc, KMEANS_ITERS)  # noqa: E731
        ms = time_ms(run)
        dms = device_ms(run, ("kmeans",))
        plain_ms = time_ms(lambda: kk.kmeans_lloyd_plain(x, kc, KMEANS_ITERS))
        plan = kk.card_plan(n, NOISE_DIM, k, torch.cuda.current_device())
        cases[k] = (err_k, tol_k, ms, plain_ms)
        print(f"[kernel] kmeans_lloyd ({n},{NOISE_DIM}) K={k} float32, "
              f"{KMEANS_ITERS} iterations in one launch (grid {plan.grid}, "
              f"{plan.tiles_per_block} tile(s) of {plan.rows} rows a block): "
              f"sums max_abs_err {err_k:.3e} (tol {tol_k:.1e}), {flipped_k} "
              f"near-tie rows assigned otherwise, centroids vs the plain run "
              f"{run_err:.3e}; bitwise repeatable; wrapper {ms:.4f} ms, "
              f"device {dms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    xr = x[:777]
    cr = c.clone()
    cr[-1] = 0.0
    cr[-1, 0] = 50.0  # no row comes near: an empty cluster
    err_r, tol_r, flipped_r, _ = lloyd_case(xr, cr, KMEANS_ITERS)
    counts = kk.kmeans_lloyd(xr, cr, KMEANS_ITERS)[1]
    check(counts[-1].item() == 0.0, "kmeans_lloyd: the far cluster is not "
          "empty")
    print(f"[kernel] kmeans_lloyd ragged (777,{NOISE_DIM}) K={KMEANS_K} with "
          f"an empty cluster: sums max_abs_err {err_r:.3e} (tol {tol_r:.1e}), "
          f"{flipped_r} near-tie rows  [{card}]")
    # the whole run: X, the centroids and counts read or written once
    b_ms, b_by = bound(KMEANS_ITERS * (2 * n * KMEANS_K * NOISE_DIM
                                       + n * NOISE_DIM),
                       4 * (n * NOISE_DIM + 2 * KMEANS_K * NOISE_DIM
                            + KMEANS_K), "float32")
    err, tol, ms, plain_ms = cases[KMEANS_K]
    return {"name": "kmeans_lloyd",
            "label": f"({n},{NOISE_DIM}) K={KMEANS_K}, {KMEANS_ITERS} "
                     f"iterations", "dtype": "float32",
            "max_abs_err": max(err, err_r, cases[KMEANS_K_WIDE][0]),
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}


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
    """Checkpoints laid out as apply_r expects (one channel as the y colour
    space, three as rgb); returns G's path."""
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.models.bridge import export_variables
    c, h, w = dims
    cfg = {"noiseDim": noise_dim, "noiseMethod": "normal",
           "colorSpace": "y" if c == 1 else "rgb", "height": h, "width": w}
    g_path = ckpt.adversarial_name(save)
    ckpt.save_checkpoint(g_path, {"G": export_variables(G)}, config=cfg)
    for model, fixer in ((R, False), (RF, True)):
        ckpt.save_checkpoint(ckpt.r_name(save, c, h, w, noise_dim, "normal",
                                         fixer),
                             {"R": export_variables(model)}, config=cfg)
    return g_path


def kernel_counters():
    from ganreverser_tpu_torch.ops import (conv_block_kernel, dense_kernel,
                                           kmeans_kernel, topk_kernel,
                                           upsample_conv_kernel)
    return {"conv_block": conv_block_kernel.conv_block,
            "upsample2_conv3x3_bn_act":
                upsample_conv_kernel.upsample2_conv3x3_bn_act,
            "upsample2_conv3x3_head":
                upsample_conv_kernel.upsample2_conv3x3_head,
            "cosine_scores": topk_kernel.cosine_scores,
            "kmeans_lloyd": kmeans_kernel.kmeans_lloyd,
            "dense_act": dense_kernel.dense_act}


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
                    needles: int = NEEDLES, noise_dim: int = NOISE_DIM,
                    exact: bool = True, f64: bool = False):
    """Phase 4c: every artifact, finite latents, cluster counts summing to
    N, the anomaly count the threshold implies, and with ``exact`` the
    search scores vs plain (an approximate search is held by its recall,
    phase 11), with ``f64`` vs the scores in f64 (phase 13: the plain f32
    sums over 49,152 pixels are the less exact side). Returns the two top-k
    score errors (none without ``exact``)."""
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
    if not exact:
        return []
    idx = torch.tensor([(i + 1) * 100 - 1 for i in range(needles)],
                       device=attrs.device)
    errs = []
    for emb, (scores, _) in ((attrs, result["attr_topk"]),
                             (images.reshape(n, -1), result["pix_topk"])):
        ref = torch.topk((cosine_scores_f64 if f64 else cosine_scores_plain)(
            emb, idx), scores.shape[1], dim=1).values
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
    check(torch.equal(dk.fused_dropout(x, s, rate), y),
          f"fused_dropout {tuple(x.shape)} {x.dtype} seed {seed}: two "
          f"runs differ")
    return err


def check_dropout(dev, card: str):
    """Phase 3, kernel B5: bitwise against the plain version at the path's
    shapes and one R step's, both dtypes, a negative seed among the seeds,
    and bitwise repeatable; the bf16 forward's median wrapper time, its
    device time, the plain hash and a plain Bernoulli mask at every shape.
    Returns one record whose times are one R step's six element dropouts
    in bf16."""
    import torch
    from ganreverser_tpu_torch.ops import dropout_kernel as dk
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    shapes = list(dict.fromkeys(DROPOUT_STEP_SHAPES + DROPOUT_SHAPES))
    err = 0.0
    for shape in shapes:
        x0 = torch.randn(shape, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            for seed in DROPOUT_SEEDS:
                err = max(err, dropout_case(x0.to(dtype), seed))
        del x0
        print(f"[kernel] fused_dropout {shape} f32+bf16 seeds "
              f"{DROPOUT_SEEDS}: forward and backward bitwise equal to "
              f"plain, bitwise repeatable  [{card}]")
    s = torch.tensor([DROPOUT_SEEDS[0]], dtype=torch.int32, device=dev)
    times = {}
    for shape in shapes:
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        times[shape] = (time_ms(lambda: dk.fused_dropout(x, s, 0.5)),
                        device_ms(lambda: dk.fused_dropout(x, s, 0.5),
                                  ("fused_dropout",)),
                        time_ms(lambda: dk.fused_dropout_plain(x, s, 0.5)),
                        time_ms(lambda: torch.where(
                            torch.rand(shape, device=dev, generator=gen) < 0.5,
                            x / 0.5, 0.0).to(x.dtype)))
        ms, dms, plain_ms, mask_ms = times[shape]
        nbytes = 2 * x.numel() * x.element_size()
        print(f"[kernel] fused_dropout {shape} bfloat16 forward: wrapper "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s), device "
              f"{dms:.4f} ms ({nbytes / dms / 1e6:.0f} GB/s), plain hash "
              f"{plain_ms:.4f} ms, plain Bernoulli mask + where "
              f"{mask_ms:.4f} ms  [{card}]")
        del x
    host = times[(256, 512)]
    print(f"[kernel] fused_dropout (256,512) bfloat16, 256 KB: wrapper "
          f"{host[0]:.4f} ms against {host[1]:.4f} ms on the device, so "
          f"{host[0] - host[1]:.4f} ms of host and launch cost a call  "
          f"[{card}]")
    ms, dms, plain_ms, mask_ms = (sum(times[sh][i] for sh in
                                      DROPOUT_STEP_SHAPES) for i in range(4))
    # one read and one write of each bf16 input, one multiply per element
    elems = sum(math.prod(sh) for sh in DROPOUT_STEP_SHAPES)
    b_ms, b_by = bound(elems, 4 * elems, "bfloat16")
    print(f"[kernel] fused_dropout, one R step's six forwards (b256 bf16): "
          f"wrapper {ms:.4f} ms, device {dms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_ms / ms:.0%} of it in the wrapper, {b_ms / dms:.0%} on the "
          f"device), plain hash {plain_ms:.4f} ms, plain Bernoulli mask + "
          f"where {mask_ms:.4f} ms  [{card}]")
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
             ("times_two", "(4,256,128), grid (16, 4)", "float32",
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
        dev_ms = device_ms(kern, ["probe_"])
        b_ms, b_by = bound(flops, nbytes, dname)
        print(f"[kernel] {name} {label} {dname}: exactly the plain version; "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})  [{card}]")
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
    dk.fused_dropout.launches = dk.fused_dropout.copies = 0
    t0 = time.perf_counter()
    out = train_r.main(args)
    seconds = time.perf_counter() - t0
    launches = dk.fused_dropout.launches
    # a non-contiguous tensor or gradient is a hidden copy before a launch
    print(f"[train] B5's wrapper copied {dk.fused_dropout.copies} "
          f"non-contiguous inputs or gradients in {launches} launches")
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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to deterministic algorithms (no autotuning) inside the
    block: its free choice sums some gradients in a varying order, which
    moves an f32 step by up to about 1.4e-5 of scale from run to run with
    the same flags (H100, phase 5e's R step)."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            saved


def precision_pin_error(G, dev, dims=DIMS, noise_dim=NOISE_DIM,
                        batch: int = 64) -> float:
    """Phase 5e: one f32 R train step through the f32 module ``G`` with the
    process-wide TF32 flags on,
    then off, from the same weights, latents and dropout masks; returns the
    largest parameter difference relative to max(1, max |param|). The step
    uses sgd (lr 0.1), whose update is linear in the gradient, so a TF32
    backward (about 1e-3 relative) would show; adam's sign-like first step
    would hide it in all but the near-zero entries. cuDNN's algorithms are
    held deterministic, so that only the flags differ between the legs."""
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
    with deterministic_cudnn():
        try:
            for tf32 in (True, False):
                torch.backends.cudnn.allow_tf32 = tf32
                torch.backends.cuda.matmul.allow_tf32 = tf32
                R = modules.init_parameters(
                    zoo.create_R(dims, noise_dim, "normal",
                                 dropout_impl="kernel"),
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
    latents and dropout masks, cuDNN's algorithms held deterministic;
    returns the largest G or D parameter difference relative to max(1,
    max |param|)."""
    import torch
    from ganreverser_tpu_torch.optim import sgd
    from ganreverser_tpu_torch.train.adversarial import (
        Confusion, make_adversarial_steps)
    f32 = torch.float32
    real, zd, zg = _gan_batches(dev, batch, 1)[0]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    params = []
    with deterministic_cudnn():
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



def _amplified(variables: dict) -> dict:
    """``variables`` with every kernel x E2E_AMPLIFY (the other leaves as
    they are)."""
    return {"params": {layer: {k: t * E2E_AMPLIFY if k == "kernel" else t
                               for k, t in leaves.items()}
                       for layer, leaves in variables["params"].items()},
            "state": variables["state"]}


def e2e_inputs(dev):
    """Phase 8's inputs: phase 4's G3 and R (the same seed), their variable
    trees on the card and a second pair's (every kernel x E2E_AMPLIFY:
    phase 4's random G draws nearly the same face from every latent, so
    the top-k of its embeddings are near ties, which the amplified pair's
    are less), and E2E_N normal latents. Returns (G, R, gv, rv, gv2, rv2,
    z)."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models import bridge
    G, R, _ = make_models(dev)
    gv, rv = bridge.module_variables(G), bridge.module_variables(R)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    z = noise_inputs(gen, E2E_N, NOISE_DIM, "normal", device=dev)
    return G, R, gv, rv, _amplified(gv), _amplified(rv), z


def wall_s(fn, reps: int) -> list:
    """Host seconds of ``reps`` calls of ``fn``, each ended by a
    synchronisation (a program's time as its caller sees it)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def first_call(fn):
    """(result, seconds, peak bytes) of a first call of a captured program
    (warm-up, capture, replay): the peak is the device memory allocated
    beyond what was allocated before it."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def cosine_scores_f64(rows, idx):
    """(Q, N) cosine scores of rows ``idx`` against every row, in f64."""
    e = rows.double()
    e = e / e.norm(dim=1, keepdim=True).clamp_min(1e-8)
    return e.index_select(0, idx) @ e.T


def topk_against_plain(rows, v, i, k: int, tol: float, f64: bool = False,
                       chunk: int = 1024):
    """The top-k (``v``, ``i``) of every row of ``rows`` against the plain
    search on the same rows (``cosine_scores_plain``, or with ``f64`` the
    scores in f64, + ``torch.topk``).
    Returns (the largest difference of the values, the largest difference
    between a returned value and the plain score of the row it names, the
    rows whose index set differs though the plain k-th score exceeds the
    (k+1)-th by more than ``tol``, the rows so separated): within ``tol``
    the first two say that the indices are a top-k of the plain scores up
    to ties, the third that where there is no tie they are its top-k."""
    import torch
    from ganreverser_tpu_torch.ops.topk_kernel import cosine_scores_plain
    n = rows.shape[0]
    err, named, bad, separated = 0.0, 0.0, 0, 0
    for s in range(0, n, chunk):
        idx = torch.arange(s, min(s + chunk, n), device=rows.device)
        scores = (cosine_scores_f64 if f64 else cosine_scores_plain)(rows,
                                                                     idx)
        rv, ri = torch.topk(scores, k + 1, dim=1)
        vc, ic = v[s:s + chunk], i[s:s + chunk]
        err = max(err, (vc - rv[:, :k]).abs().max().item())
        named = max(named, (scores.gather(1, ic) - vc).abs().max().item())
        sep = (rv[:, k - 1] - rv[:, k]) > tol
        differ = (torch.sort(ic, 1).values
                  != torch.sort(ri[:, :k], 1).values).any(1)
        bad += int((differ & sep).sum())
        separated += int(sep.sum())
    return err, named, bad, separated


def check_topk(what: str, rows, v, i, k: int, tol: float,
               f64: bool = False, separated_rows: bool = False) -> str:
    """:func:`topk_against_plain` within ``tol``, or fail; its line. With
    ``separated_rows`` it also fails when no row is so separated, so that
    the index check has rows to compare."""
    err, named, bad, separated = topk_against_plain(rows, v, i, k, tol, f64)
    check(err <= tol and named <= tol and bad == 0, f"e2e {what}: top-k vs "
          f"the plain search: values {err}, named rows' scores {named}, "
          f"{bad} separated rows with other indices (tol {tol})")
    check(separated > 0 or not separated_rows, f"e2e {what}: no row's k-th "
          f"score leads its (k+1)-th by more than {tol}, so no index set was "
          "compared")
    return (f"{what}: top-k values vs the plain search"
            f"{' in f64' if f64 else ''} max_abs_err "
            f"{err:.3e}, the named rows' plain scores {named:.3e} (tol "
            f"{tol:.0e}), index sets equal on all {separated} of "
            f"{rows.shape[0]} rows whose k-th score leads the (k+1)-th by "
            f"more than the tol")


def check_e2e(dev, card: str):
    """Phase 8: the fused generate -> invert -> top-k program at full width
    (see the module docstring). Returns the launches of its first call."""
    import torch
    from ganreverser_tpu_torch.analysis import e2e
    from ganreverser_tpu_torch.analysis.similarity import normalize_rows
    from ganreverser_tpu_torch.ops import (conv_block_kernel, dense_kernel,
                                           topk_kernel, upsample_conv_kernel)
    uc = upsample_conv_kernel
    counters = {"upsample2_conv3x3_bn_act": uc.upsample2_conv3x3_bn_act,
                "upsample2_conv3x3_head": uc.upsample2_conv3x3_head,
                "conv_block": conv_block_kernel.conv_block,
                "cosine_scores": topk_kernel.cosine_scores,
                "dense_act": dense_kernel.dense_act}
    G, R, gv, rv, gv2, rv2, z = e2e_inputs(dev)
    n = E2E_N

    def program(batch=E2E_BATCHES[0], pixel_k=0, capture=True):
        return e2e.make_e2e_program(
            G, R, batch_size=batch, k=E2E_K, needle_chunk=E2E_CHUNK,
            pixel_k=pixel_k, capture=capture,
            **e2e.fast_legs(DIMS, NOISE_DIM, "normal"))

    def rate(times):
        return n / statistics.median(times)

    # the fused graph as a caller drives it: its first call, counted
    fused = program()
    for fn in counters.values():
        fn.launches = 0
    (emb, v, i), first_s, peak_fused = first_call(lambda: fused(gv, rv, z))
    launches = {name: fn.launches for name, fn in counters.items()}
    for name in counters:
        check(launches[name] > 0, f"e2e: kernel {name} launched no time in "
              "the fused program's first call")
    before = dict(launches)
    out = fused(gv, rv, z)
    torch.cuda.synchronize()
    per_replay = {name: fn.launches - before[name]
                  for name, fn in counters.items()}
    chunks = -(-n // E2E_BATCHES[0])
    expected = {"upsample2_conv3x3_bn_act": chunks,
                "upsample2_conv3x3_head": chunks,
                "conv_block": 6 * chunks,
                "cosine_scores": -(-n // E2E_CHUNK),
                "dense_act": 3 * chunks}  # G l0, R l27, R l31
    check(per_replay == expected, f"e2e: launches per replay {per_replay}, "
          f"expected {expected}")
    # the counts above are the capture's, added again at each replay: the
    # kernels one replay ran on the device, from a trace
    traced = device_counts(lambda: fused(gv, rv, z), E2E_DEVICE_KERNELS)
    check(traced == expected, f"e2e: device kernels of one traced replay "
          f"{traced}, expected {expected}")
    check(all(torch.equal(a, b) for a, b in zip(out, (emb, v, i))),
          "e2e: a second replay differs from the first")
    check(tuple(emb.shape) == (n, NOISE_DIM) and bool(
        torch.isfinite(emb).all()), f"e2e: embeddings {tuple(emb.shape)} "
          "or non-finite")
    topk_line = check_topk("attributes", emb, v, i, E2E_K, TOL_TOPK)
    t_graph = wall_s(lambda: fused(gv, rv, z), E2E_TIMES)

    # a replay against the eager program, and a call with other weights
    eager = program(capture=False)
    check(all(torch.equal(a, b) for a, b in zip(eager(gv, rv, z), out)),
          "e2e: the graph's replay differs from the eager program")
    t_eager = wall_s(lambda: eager(gv, rv, z), 3)
    other = fused(gv2, rv2, z)
    check(not torch.equal(other[0], emb) and all(
        torch.equal(a, b) for a, b in zip(other, eager(gv2, rv2, z))),
        "e2e: a call with other weights did not give their result")
    topk_line2 = check_topk(f"G's and R's kernels x{E2E_AMPLIFY:g}", *other,
                            E2E_K, TOL_TOPK, separated_rows=True)
    check(torch.equal(fused(gv, rv, z)[0], emb),
          "e2e: the first weights again did not give the first result")
    del eager, other, out

    # the serial programs on the same legs
    generate, invert, search = e2e.make_serial_programs(
        G, R, batch_size=E2E_BATCHES[0], k=E2E_K, needle_chunk=E2E_CHUNK,
        **e2e.fast_legs(DIMS, NOISE_DIM, "normal"))

    def serial():
        images = generate(gv, z)
        s_emb = invert(rv, images)
        return images, s_emb, search(s_emb)

    (images, s_emb, (sv, si)), _, peak_serial = first_call(serial)
    check(torch.equal(s_emb, emb) and torch.equal(sv, v)
          and torch.equal(si, i), "e2e: the serial programs differ from the "
          "fused program")
    t_serial = [statistics.median(wall_s(fn, 3)) for fn in (
        lambda: generate(gv, z), lambda: invert(rv, images),
        lambda: search(s_emb))]
    del invert, search, s_emb, sv, si
    print(f"[e2e] fused program N={n} bf16 batch {E2E_BATCHES[0]} k={E2E_K}"
          f" chunk {E2E_CHUNK}: graph {rate(t_graph):.1f} img/s (median of "
          f"{E2E_TIMES}: {statistics.median(t_graph):.4f} s; first call, "
          f"warm-up + capture + replay, {first_s:.2f} s), eager program "
          f"{rate(t_eager):.1f} img/s ({statistics.median(t_eager):.4f} s), "
          f"serial graphs {n / sum(t_serial):.1f} img/s (generate "
          f"{t_serial[0]:.4f} + invert {t_serial[1]:.4f} + search "
          f"{t_serial[2]:.4f} s)  [{card}]")
    print(f"[e2e] peak device memory of a first call: fused "
          f"{peak_fused / 2 ** 30:.3f} GiB, serial (the three programs) "
          f"{peak_serial / 2 ** 30:.3f} GiB, the image tensor "
          f"{images.numel() * images.element_size() / 2 ** 30:.3f} GiB  "
          f"[{card}]")
    print(f"[e2e] checks: replays bitwise equal, bitwise the eager program "
          f"and the serial programs; other weights give their own result; "
          f"{topk_line}; {topk_line2}; launches per replay {per_replay}, "
          f"the same kernels in a traced replay  [{card}]")

    # the pixel leg: its top-k against the plain search on the same images
    pix = program(pixel_k=E2E_PIXEL_K)
    p_out = pix(gv, rv, z)
    check(torch.equal(p_out[0], emb), "e2e: the pixel program's embeddings "
          "differ")
    # kernel C's scores at D = 12,288 against the exact scores: the plain
    # f32 search's own sums of 12,288 products lie up to about 1e-4 from
    # them, C's (a slice at most MAX_SLICE_CHUNKS deep) within 1e-5
    p_line = check_topk("pixels", images.reshape(n, -1), p_out[3], p_out[4],
                        E2E_PIXEL_K, TOL_TOPK, f64=True)
    t_pix = wall_s(lambda: pix(gv, rv, z), 3)
    # the amplified pair's images are far enough apart that rows are
    # separated, so that the pixel leg's indices are held to the f64 search
    p_out = pix(gv2, rv2, z)
    p_line2 = check_topk(f"pixels, G's and R's kernels x{E2E_AMPLIFY:g}",
                         generate(gv2, z).reshape(n, -1), p_out[3], p_out[4],
                         E2E_PIXEL_K, TOL_TOPK, f64=True, separated_rows=True)
    del pix, p_out, generate
    torch.cuda.empty_cache()
    print(f"[e2e] with the pixel measure (pixel_k={E2E_PIXEL_K}): graph "
          f"{rate(t_pix):.1f} img/s ({statistics.median(t_pix):.4f} s); "
          f"{p_line}; {p_line2}  [{card}]")

    # batch 256
    prog = program(batch=E2E_BATCHES[1])
    o = prog(gv, rv, z)
    check(bool(torch.isfinite(o[0]).all()),
          f"e2e batch {E2E_BATCHES[1]}: non-finite")
    diff = (o[0].float() - emb.float()).abs().max().item()
    t = wall_s(lambda: prog(gv, rv, z), 3)
    print(f"[e2e] batch {E2E_BATCHES[1]}: graph {rate(t):.1f} img/s "
          f"({statistics.median(t):.4f} s; embeddings max_abs_err vs "
          f"the program above {diff:.3e})  [{card}]")
    del prog, o
    torch.cuda.empty_cache()

    # kernel C's search against one plain product of normalised rows
    for label, rows, k in (("attributes", emb, E2E_K),
                           ("pixels", images.reshape(n, -1), E2E_PIXEL_K)):
        def library(rows=rows, k=k):  # JAX's topk_all: normalise, then
            normed = normalize_rows(rows)  # one product per needle chunk
            return e2e.chunked_topk_search(normed, normed, k, E2E_CHUNK)
        ms = time_ms(lambda: e2e.topk_all(rows, k, E2E_CHUNK), reps=5)
        lib_ms = time_ms(library, reps=5)
        print(f"[e2e] search {label} ({n},{rows.shape[1]}) bf16, k={k}, "
              f"needle chunk {E2E_CHUNK}: kernel C + torch.topk {ms:.4f} ms,"
              f" torch.matmul of normalised rows + torch.topk {lib_ms:.4f} "
              f"ms (eager calls, CUDA events, median of 5)  [{card}]")
    del fused, images
    torch.cuda.empty_cache()
    return launches, rate(t_graph)


# -- phase 9: the Torch7 import ------------------------------------------

T7_EPOCH = 4             # the adversarial file's epoch; train resumes at 5
T7_TRAIN_BATCHES = 10    # --N_epoch of the resumed epoch (depth; 30)
INITS = ("heuristic", "torch", "xavier", "xavier_caffe", "kaiming")


class T7Object:
    """A torch class instance to serialize: its class name and fields."""

    def __init__(self, cls: str, **payload):
        self.cls = cls
        self.payload = payload


def t7_bytes(obj) -> bytes:
    """``obj`` in Torch7's binary ``torch.save`` format (the reference's
    ``*.net`` files; the record layout is io/torch7.py's): nil, numbers,
    strings, booleans, tables (dicts; lists as 1-based tables), torch
    class instances (:class:`T7Object`) and numpy arrays as
    torch.FloatTensor over their own FloatStorage. Nothing is shared, so
    every table and object gets a new memo index."""
    import struct
    import numpy as np
    out, idx = [], [0]

    def i32(v):
        out.append(struct.pack("<i", v))

    def i64(v):
        out.append(struct.pack("<q", v))

    def string(v):
        b = v.encode()
        i32(len(b))
        out.append(b)

    def index():
        idx[0] += 1
        i32(idx[0])

    def torch_class(name):
        i32(4)
        index()
        string("V 1")
        string(name)

    def write(o):
        if o is None:
            i32(0)
        elif isinstance(o, bool):
            i32(5)
            i32(int(o))
        elif isinstance(o, (int, float)):
            i32(1)
            out.append(struct.pack("<d", float(o)))
        elif isinstance(o, str):
            i32(2)
            string(o)
        elif isinstance(o, np.ndarray):
            arr = np.ascontiguousarray(o, dtype="<f4")
            torch_class("torch.FloatTensor")
            i32(arr.ndim)
            for d in arr.shape:
                i64(d)
            for st in arr.strides:
                i64(st // 4)
            i64(1)  # storageOffset, 1-based
            torch_class("torch.FloatStorage")
            i64(arr.size)
            out.append(arr.tobytes())
        elif isinstance(o, (list, tuple)):
            write({i + 1: v for i, v in enumerate(o)})
        elif isinstance(o, dict):
            i32(3)
            index()
            i32(len(o))
            for k, v in o.items():
                write(k)
                write(v)
        elif isinstance(o, T7Object):
            torch_class(o.cls)
            write(dict(o.payload))
        else:
            raise TypeError(type(o))

    write(obj)
    return b"".join(out)


# A reference network as models.lua builds it, in torch's layouts (NCHW
# activations, (out, in) Linear and OIHW conv weights, C-major nn.View):
# a list of ops, each a tuple (kind, *fields). ``nchw_forward`` runs it
# with torch.nn.functional; ``t7_module`` serializes it as the reference's
# nn graph. Both stand apart from the port's modules and importer.

def _np32(t):
    return t.detach().float().cpu().numpy()


def _t_linear(dense, in_hwc=None, out_hwc=None):
    """The port's Dense as an nn.Linear: (out, in) weight; a Flatten of
    (h, w, c) maps before it or a View to (c, h, w) after it orders the
    units C-major."""
    k = dense.kernel.detach().float()
    b = dense.bias.detach().float()
    w = k.T
    if in_hwc is not None:
        h, wd, c = in_hwc
        w = w.reshape(-1, h, wd, c).permute(0, 3, 1, 2).reshape(w.shape[0],
                                                                 -1)
    if out_hwc is not None:
        h, wd, c = out_hwc
        w = w.reshape(h, wd, c, -1).permute(2, 0, 1, 3).reshape(
            -1, w.shape[1])
        b = b.reshape(h, wd, c).permute(2, 0, 1).reshape(-1)
    return ("linear", w.contiguous(), b.contiguous())


def _t_conv(conv, cls="cudnn.SpatialConvolution"):
    return ("conv", conv.kernel.detach().float().permute(3, 2, 0, 1)
            .contiguous(), conv.bias.detach().float(), cls)


def _t_bn(bn, spatial=True, chw_of_hwc=None):
    """nn.SpatialBatchNormalization, or nn.BatchNormalization after a
    Linear (its units C-major when a View to (c, h, w) follows)."""
    vs = [v.detach().float() for v in (bn.scale, bn.bias, bn.mean, bn.var)]
    if chw_of_hwc is not None:
        h, w, c = chw_of_hwc
        vs = [v.reshape(h, w, c).permute(2, 0, 1).reshape(-1) for v in vs]
    return ("bn", *vs, spatial)


def _t_prelu(p):
    return ("prelu", p.alpha.detach().float())


def g3_reference(G, dims=DIMS):
    """create_G3 (models.lua:104-143) as a GPU-trained file holds it:
    nn.Copy at both ends, cudnn convs."""
    c, h, w = dims
    hwc = (h // 4, w // 4, 512)
    return [("copy",), _t_linear(G.l0, out_hwc=hwc),
            _t_bn(G.l1, False, hwc),
            ("relu",), ("view", (512, h // 4, w // 4)),
            ("up",), _t_conv(G.l5), _t_bn(G.l6), ("relu",),
            ("up",), _t_conv(G.l9), _t_bn(G.l10), ("relu",),
            _t_conv(G.l12), ("sigmoid",), ("copy",)]


def d2_reference(D, dims=DIMS):
    """create_D2 (models.lua:272-337): createNxN sub-Sequentials of plain
    nn convs, an nn.Concat of the two branches."""
    c, h, w = dims

    def nxn(block, drop=True):
        ops = [_t_conv(block.l0, "nn.SpatialConvolution"),
               _t_prelu(block.l1)]
        return ("seq", ops + ([("sdropout",)] if drop else []))

    left, right = D.l3.b0, D.l3.b1
    left_ops = [nxn(left.l0), ("maxpool",), ("view", None),
                _t_linear(left.l3, in_hwc=(h // 4, w // 4, 64)),
                _t_prelu(left.l4), ("dropout",)]
    right_ops = [nxn(right.l0), ("maxpool",), nxn(right.l2),
                 nxn(right.l3), ("maxpool",), ("view", None),
                 _t_linear(right.l6, in_hwc=(h // 8, w // 8, 256)),
                 _t_prelu(right.l7)]
    return [("copy",), nxn(D.l0, drop=False), nxn(D.l1), ("maxpool",),
            ("concat", [left_ops, right_ops]),
            _t_linear(D.l4), _t_prelu(D.l5), ("dropout",),
            _t_linear(D.l7), ("sigmoid",), ("copy",)]


def r_reference(R, dims=DIMS):
    """create_R_default (models.lua:389-464), the fixer's always-on input
    dropout first where it has one, nn.Copy at both ends."""
    from ganreverser_tpu_torch.models import modules
    c, h, w = dims
    ops, shape, flat = [("copy",)], (h, w, c), None
    for m in R.children():
        if isinstance(m, modules.Conv):
            ops.append(_t_conv(m, "nn.SpatialConvolution"))
            shape = shape[:2] + (m.kernel.shape[-1],)
        elif isinstance(m, modules.BatchNorm):
            ops.append(_t_bn(m, spatial=ops[-1][0] == "conv"))
        elif isinstance(m, modules.Activation):
            ops.append((m.fn,))
        elif isinstance(m, modules.SpatialDropout):
            ops.append(("sdropout",))
        elif isinstance(m, modules.Dropout):
            ops.append(("dropout",))
        elif isinstance(m, modules.MaxPool):
            ops.append(("maxpool",))
            shape = (shape[0] // 2, shape[1] // 2, shape[2])
        elif isinstance(m, modules.Flatten):
            ops.append(("view", None))
            flat = shape
        elif isinstance(m, modules.Dense):
            ops.append(_t_linear(m, in_hwc=flat))
            flat = None
        else:
            raise TypeError(type(m).__name__)
    return ops + [("copy",)]


def nchw_forward(ops, x):
    """The reference network in evaluation (dropouts the identity) on NCHW
    (or (N, features)) ``x``, f32 with TF32 off."""
    import torch
    import torch.nn.functional as F
    from ganreverser_tpu_torch.core.precision import pinned_precision
    with pinned_precision(torch.float32), torch.no_grad():
        for op in ops:
            kind = op[0]
            if kind == "linear":
                x = F.linear(x, op[1], op[2])
            elif kind == "conv":
                x = F.conv2d(x, op[1], op[2],
                             padding=(op[1].shape[-1] - 1) // 2)
            elif kind == "bn":
                x = F.batch_norm(x, op[3], op[4], op[1], op[2],
                                 training=False, eps=1e-5)
            elif kind == "prelu":
                x = F.prelu(x, op[1])
            elif kind in ("relu", "elu", "sigmoid", "tanh"):
                x = {"relu": F.relu, "elu": F.elu, "sigmoid": torch.sigmoid,
                     "tanh": torch.tanh}[kind](x)
            elif kind == "view":
                x = x.reshape((x.shape[0],) + (op[1] or (-1,)))
            elif kind == "up":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif kind == "maxpool":
                x = F.max_pool2d(x, 2)
            elif kind == "seq":
                x = nchw_forward(op[1], x)
            elif kind == "concat":
                x = torch.cat([nchw_forward(b, x) for b in op[1]], dim=1)
            # copy, dropout, sdropout: the identity in evaluation
    return x


_T7_CLASSES = {"copy": "nn.Copy", "relu": "cudnn.ReLU", "elu": "nn.ELU",
               "sigmoid": "nn.Sigmoid", "tanh": "nn.Tanh", "view": "nn.View",
               "up": "nn.SpatialUpSamplingNearest",
               "maxpool": "nn.SpatialMaxPooling", "dropout": "nn.Dropout",
               "sdropout": "nn.SpatialDropout"}


def t7_module(ops) -> T7Object:
    """The reference network as the nn.Sequential torch.save writes."""
    mods = []
    for op in ops:
        kind = op[0]
        if kind == "linear":
            mods.append(T7Object("nn.Linear", weight=_np32(op[1]),
                                 bias=_np32(op[2])))
        elif kind == "conv":
            o, i, kh, kw = op[1].shape
            mods.append(T7Object(op[3], weight=_np32(op[1]),
                                 bias=_np32(op[2]), nInputPlane=i,
                                 nOutputPlane=o, kH=kh, kW=kw))
        elif kind == "bn":
            mods.append(T7Object(
                "nn.SpatialBatchNormalization" if op[5]
                else "nn.BatchNormalization", weight=_np32(op[1]),
                bias=_np32(op[2]), running_mean=_np32(op[3]),
                running_var=_np32(op[4]), eps=1e-5))
        elif kind == "prelu":
            mods.append(T7Object("nn.PReLU", weight=_np32(op[1])))
        elif kind == "seq":
            mods.append(t7_module(op[1]))
        elif kind == "concat":
            mods.append(T7Object("nn.Concat", dimension=2,
                                 modules=[t7_module(b) for b in op[1]]))
        else:
            mods.append(T7Object(_T7_CLASSES[kind]))
    return T7Object("nn.Sequential", modules=mods)


def reference_parameters(ops) -> int:
    """Learnable values of a reference network (weights, biases, BN
    affine, PReLU slopes)."""
    n = 0
    for op in ops:
        if op[0] in ("linear", "conv"):
            n += op[1].numel() + op[2].numel()
        elif op[0] == "bn":
            n += op[1].numel() + op[2].numel()
        elif op[0] == "prelu":
            n += op[1].numel()
        elif op[0] == "seq":
            n += reference_parameters(op[1])
        elif op[0] == "concat":
            n += sum(reference_parameters(b) for b in op[1])
    return n


def write_t7_files(G, D, R, RF, tmp: str, vis, dims=DIMS,
                   noise_dim=NOISE_DIM):
    """The reference's three save files of these networks: train.lua:256's
    adversarial {G, D, opt, plot_data, epoch, vis_noise_inputs} and
    train_r.lua:234's {R, opt} for R and the fixer-R. Returns
    ({name: path}, {name: reference ops}, seconds)."""
    c, h, w = dims
    t0 = time.perf_counter()
    refs = {"G": g3_reference(G, dims), "D": d2_reference(D, dims),
            "R": r_reference(R, dims), "R_fixer": r_reference(RF, dims)}
    geo = {"noiseDim": noise_dim, "noiseMethod": "normal", "height": h,
           "width": w, "colorSpace": "rgb" if c == 3 else "y"}
    files = {
        "adversarial.net": {
            "G": t7_module(refs["G"]), "D": t7_module(refs["D"]),
            "opt": {**geo, "batchSize": TRAIN_BATCH, "seed": SEED,
                    "D_optmethod": "adam", "G_optmethod": "adam",
                    "gpu": 0, "window": 3},
            "plot_data": [[e, 0.7 - 0.01 * e, 0.8 + 0.01 * e, 0.5]
                          for e in range(1, T7_EPOCH + 1)],
            "epoch": T7_EPOCH, "vis_noise_inputs": vis},
        "r.net": {"R": t7_module(refs["R"]),
                  "opt": {**geo, "fixer": False, "batchSize": TRAIN_BATCH,
                          "seed": SEED}},
        "r_fixer.net": {"R": t7_module(refs["R_fixer"]),
                        "opt": {**geo, "fixer": True,
                                "batchSize": TRAIN_BATCH, "seed": SEED}}}
    paths = {}
    for name, obj in files.items():
        paths[name] = os.path.join(tmp, name)
        with open(paths[name], "wb") as f:
            f.write(t7_bytes(obj))
    return paths, refs, time.perf_counter() - t0


def shown_counts(path: str) -> dict:
    """``cli.show.main`` on a checkpoint: {model: parameters} from its
    '-- <model>: N parameters' lines."""
    import contextlib
    import io
    from ganreverser_tpu_torch.cli import show
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        show.main([path])
    counts = {}
    for line in buf.getvalue().splitlines():
        m = re.match(r"-- (\w+): (\d+) parameters$", line)
        if m:
            counts[m.group(1)] = int(m.group(2))
    return counts


def check_init_draws(dev, dims=DIMS, noise_dim=NOISE_DIM) -> int:
    """G3, D2 and R with each init drawn on the card from a CUDA generator:
    every weight within its scheme's half-width, the biases zero or drawn
    as the layer says, the BatchNorm scales ones or in [0, 1). Returns the
    number of layers checked."""
    import torch
    from ganreverser_tpu_torch.models import modules, zoo
    from ganreverser_tpu_torch.models.init import scheme_std
    n = 0
    for i, init in enumerate(INITS):
        gen = torch.Generator(device=dev).manual_seed(SEED + 30 + i)
        for model in (zoo.create_G3(dims, noise_dim, init=init),
                      zoo.create_D2(dims, init=init),
                      zoo.create_R(dims, noise_dim, "normal", init=init)):
            modules.init_parameters(model.to(dev), gen)
            for m in model.modules():
                if isinstance(m, modules.BatchNorm):
                    s = m.scale
                    ok = (bool(((s >= 0) & (s < 1)).all())
                          and s.std().item() > 0.1
                          if m.scale_init == "torch"
                          else bool((s == 1).all()))
                    check(ok, f"init {init}: BN scales out of range")
                elif isinstance(m, (modules.Dense, modules.Conv)):
                    k, b = m.kernel, m.bias
                    fans = (k.shape if k.ndim == 2 else
                            (k.shape[0] * k.shape[1] * k.shape[2],
                             k.shape[0] * k.shape[1] * k.shape[3]))
                    hw = scheme_std(m.init_scheme, *fans) * (1 + 1e-6)
                    check(k.is_cuda and k.abs().max().item() <= hw
                          and k.abs().max().item() > 0.5 * hw,
                          f"init {init}: a {tuple(k.shape)} kernel outside "
                          f"its half-width {hw}")
                    check(bool((b == 0).all()) if m.init_zero_bias else
                          0 < b.abs().min().item() <= b.abs().max().item()
                          <= hw, f"init {init}: a {tuple(b.shape)} bias")
                else:
                    continue
                n += 1
    return n


def check_t7_import(dev, card: str, tmp: str) -> dict:
    """Phase 9: the reference user's path at full width (see the module
    docstring). Returns the kernels' launches of its apply_r run and its
    resumed train epoch."""
    import numpy as np
    import torch
    from ganreverser_tpu_torch.cli import import_t7, show, train
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    from ganreverser_tpu_torch.models import bridge, fastpath
    from ganreverser_tpu_torch.ops import conv_kernel
    t_phase = time.perf_counter()
    c, h, w = DIMS
    f32 = torch.float32
    G, R, RF = make_models(dev, DIMS, NOISE_DIM)
    D = make_d2(dev, DIMS)
    vis = np.random.default_rng(SEED + 40).normal(
        size=(100, NOISE_DIM)).astype(np.float32)
    paths, refs, write_s = write_t7_files(G, D, R, RF, tmp, vis)
    del G, R, RF, D
    sizes = {k: os.path.getsize(p) / 2 ** 20 for k, p in paths.items()}
    print(f"[t7] wrote " + ", ".join(f"{k} {v:.1f} MiB"
                                     for k, v in sizes.items())
          + f" in {write_s:.2f} s  [{card}]")
    show.main([paths["adversarial.net"]])

    save = os.path.join(tmp, "logs")
    ckpts, import_s = {}, {}
    for name, path in paths.items():
        t0 = time.perf_counter()
        ckpts[name] = import_t7.main([path, "--out", save])
        import_s[name] = time.perf_counter() - t0
    check(ckpts["adversarial.net"] == ckpt.adversarial_name(save)
          and ckpts["r_fixer.net"] == ckpt.r_name(save, c, h, w, NOISE_DIM,
                                                  "normal", True),
          f"imported checkpoints {ckpts}")
    for name, want in (("adversarial.net", {"G": refs["G"], "D": refs["D"]}),
                       ("r.net", {"R": refs["R"]}),
                       ("r_fixer.net", {"R": refs["R_fixer"]})):
        got = shown_counts(ckpts[name])
        want = {k: reference_parameters(v) for k, v in want.items()}
        check(got == want, f"show {name}: parameters {got}, the reference "
              f"networks have {want}")
        print(f"[t7] show {os.path.basename(ckpts[name])}: " + ", ".join(
            f"{k} {v:,} parameters" for k, v in got.items())
            + " (= the reference networks')")
    print(f"[t7] import seconds, {c}x{h}x{w} noise {NOISE_DIM}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in import_s.items()) + f"  [{card}]")

    # the fast paths on the imported weights against the NCHW forwards
    tree, _, extra = ckpt.load_checkpoint(ckpts["adversarial.net"])
    check(extra["epoch"] == T7_EPOCH and len(extra["plot_data"]) == T7_EPOCH
          and np.array_equal(tree["vis_noise_inputs"], vis),
          "the imported extra or visualisation noise differ from the file")

    def variables(t):
        return bridge.to_torch({"params": t["params"], "state": t["state"]},
                               dev)

    g_vars, d_vars = variables(tree["G"]), variables(tree["D"])
    r_vars = variables(ckpt.load_checkpoint(ckpts["r.net"])[0]["R"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    z = noise_inputs(gen, N_COMPARE, NOISE_DIM, "normal", device=dev)
    ref_images = nchw_forward(refs["G"], z)
    x = ref_images.permute(0, 2, 3, 1).contiguous()
    errs = {}
    with torch.inference_mode():
        errs["G"] = _path_err("imported G", fastpath.make_fast_generator(
            DIMS, NOISE_DIM, f32)(g_vars, z), x)
        errs["R"] = _path_err(
            "imported R", fastpath.make_fast_inverter(
                DIMS, NOISE_DIM, "normal", f32)(r_vars, x),
            nchw_forward(refs["R"], ref_images))
        errs["D"] = _path_err(
            "imported D", fastpath.make_fast_discriminator(DIMS, f32)(
                d_vars, x), nchw_forward(refs["D"], ref_images))
    print(f"[t7] fast paths on imported weights vs the NCHW reference "
          f"forwards, f32, {N_COMPARE} rows: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {TOL_PATH:.0e} of scale)  [{card}]")
    del g_vars, d_vars, r_vars, ref_images, x

    # apply_r on the imported checkpoints, phase 4's arguments
    out_dir = os.path.join(tmp, "apply_out")
    result, launches, seconds = run_main_path(ckpts["adversarial.net"], save,
                                              out_dir)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} launched no time in apply_r on "
              "the imported checkpoints")
    check(launches["kmeans_lloyd"] == 1,
          f"kmeans_lloyd launched {launches['kmeans_lloyd']} times")
    score_errs = check_main_path(result, out_dir)
    secs = result["seconds"]
    del result
    print(f"[t7] apply_r N={N_MAIN} bf16 batch 256 on the imported G, R "
          f"and fixer-R: whole call {seconds:.2f} s; launches {launches}; "
          f"top-k score error vs plain {max(score_errs):.2e}  [{card}]")
    print(f"[t7] stage seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in secs.items()) +
        f"; generate+invert {N_MAIN / secs['generate_invert']:.1f} img/s  "
        f"[{card}]")

    # one train epoch resumed from the imported file
    conv_kernel.conv3x3_bn_act.launches = 0
    t0 = time.perf_counter()
    out = train.main(["--dataset", "synthetic", "--save",
                      os.path.join(tmp, "gan"), "--network",
                      ckpts["adversarial.net"], "--height", str(h),
                      "--width", str(w), "--noiseDim", str(NOISE_DIM),
                      "--batchSize", str(TRAIN_BATCH), "--compute_dtype",
                      "bfloat16", "--N_epoch", str(T7_TRAIN_BATCHES),
                      "--epochs", str(T7_EPOCH + 1), "--saveFreq", "1"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    n_b6 = conv_kernel.conv3x3_bn_act.launches
    epochs = [r["epoch"] for r in out["epochs"]]
    losses = out["epochs"][0]["d_losses"] + out["epochs"][0]["g_losses"]
    check(epochs == [T7_EPOCH + 1], f"resumed train ran epochs {epochs}")
    check(np.array_equal(out["vis_noise"].cpu().numpy(), vis),
          "the resumed train has another visualisation noise")
    check(n_b6 == 10, f"resumed train: B6 launched {n_b6} times, not 10")
    check(len(losses) == 2 * T7_TRAIN_BATCHES
          and all(map(math.isfinite, losses)), "resumed train: losses")
    check([row[0] for row in out["plot_data"]]
          == list(range(1, T7_EPOCH + 2)), "resumed train: loss history")
    print(f"[t7] train --network <imported> b{TRAIN_BATCH} bf16, "
          f"{T7_TRAIN_BATCHES} batches: epoch {epochs[0]}, "
          f"{train_s:.2f} s, B6 launches {n_b6}, d "
          f"{statistics.mean(out['epochs'][0]['d_losses']):.4f} g "
          f"{statistics.mean(out['epochs'][0]['g_losses']):.4f}  [{card}]")
    del out

    n_layers = check_init_draws(dev)
    print(f"[t7] init on the card (CUDA generator), G3, D2 and R x "
          f"{', '.join(INITS)}: {n_layers} layers within their half-widths"
          f"  [{card}]")
    print(f"[time] phase 9 {time.perf_counter() - t_phase:.1f} s  [{card}]")
    torch.cuda.empty_cache()
    launches["conv3x3_bn_act"] = n_b6
    return launches


# -- phase 10: serving and the int8 legs ------------------------------------

SERVE_BATCH = 256        # export --batch of invert and generate
SERVE_E2E = (E2E_N, E2E_BATCHES[0], E2E_K)   # export --what e2e: N, batch, k
# export --what e2e --int8: N cut to a quarter (its trace at N = 10,240
# took 81.5 s on an NVIDIA H100 80GB HBM3 host, against 37.3 s in bf16)
SERVE_E2E_INT8_N = E2E_N // 4
TOL_SERVE = 1e-3         # loaded artifact vs live program, of max(1, scale)
SERVE_CPU_ROWS = 16      # rows of the CPU leg held to the plain path
# Q1-Q3's dequantised outputs vs their plain versions, of max(1, |plain|):
# one FMA rounding on both sides; expm1 and the sigmoid in CUDA's libdevice
# against PyTorch's (their int8 and int32 parts must be bitwise)
TOL_INT8 = 1e-6
INT8_LINES = ("quant_conv3x3_same", "quant_upsample2_conv3x3", "quant_dense",
              "quant_act", "quant_act_max")
S8_LINES = INT8_LINES[:3]   # Q1, Q2 and Q3, on the int8 tensor cores
# the kernels' wrapper times before their redesign at the same shapes, from
# this phase (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6): Q1's and
# Q2's __dp4a kernels by label and summed, Q3's __dp4a kernel at its three
# shapes, Q4's two launches at five sizes (R's and G's layer inputs)
Q_BEFORE_MS = {"G l12": 0.34, "G stage 1": 3.92, "G stage 2": 4.12}
Q_BEFORE_SUMS = {"quant_conv3x3_same": 5.549, "quant_upsample2_conv3x3": 8.036,
                 "quant_dense": 0.521, "quant_act": 0.813}
# Q1 and Q2 off every tile edge, batch 1: H and W off the 8 x 16 patch, Ci
# off 32 bytes (5, 40, 70, 130: rows of 32, 64, 80 and 144), Co off BN
# (3, 70, 130; 300 over two blocks of 256); (N, H, W, Ci, Co, act[, pool])
Q1_RAGGED = [(1, 13, 21, 40, 70, "none", False),
             (1, 10, 18, 5, 3, "relu", True),
             (1, 13, 21, 130, 300, "elu", False),
             (1, 6, 10, 70, 130, "sigmoid", True)]
Q2_RAGGED = [(1, 5, 7, 40, 130, "relu"), (1, 9, 17, 130, 300, "none"),
             (1, 3, 5, 5, 3, "sigmoid")]
# Q3 off every tile edge: N off 128 rows, K off 16 bytes and off the
# chunk, M off BN; one K split over 8 (70 x 4096 . 4096 x 130);
# (N, K, M, act)
Q3_RAGGED = [(7, 10, 13, "elu"), (70, 4096, 130, "relu"),
             (1, 40, 300, "sigmoid")]
# Q4's launches a chunk of apply_r --int8 stage ②: two each for the two
# entry quantisers (z, the images), one for each of the ten quantisers
# after an int8 producer (24 before the producers took the max)
Q4_LAUNCHES_A_CHUNK = 14
# the int8 e2e program's top-100 recall against the bf16 program on phase
# 8's x3 weights, the weights' per-channel scales in IEEE division: both
# programs are deterministic and the int8 sums exact, so another value is
# a fault (0.6235 until the bf16 program's dense layers moved onto kernel
# D, whose f32 sums run in another order)
INT8_RECALL = 0.6234
# a process that loads artifacts with io.serving alone: loads each on the
# card, runs it on the saved input (first call: capture + replay), saves
# its outputs, counts its kernels in one traced call and times the e2e
# artifact warm; then the invert artifact on the CPU; prints a JSON line
SERVE_LOADER = r"""
import json, statistics, sys, time
root, spec = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
import torch
from ganreverser_tpu_torch.io.serving import load_serving_program
import chip_smoke as cs
out = {}
for what, d in spec["card"].items():
    t0 = time.perf_counter()
    call, meta = load_serving_program(d["path"])
    load_s = time.perf_counter() - t0
    x = torch.load(d["input"]).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = call(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ys = y if isinstance(y, tuple) else (y,)
    torch.save([t.cpu() for t in ys], d["output"])
    rec = {"load_s": load_s, "first_s": first_s,
           "counts": cs.device_counts(lambda: call(x), cs.E2E_DEVICE_KERNELS)}
    if what == "e2e":
        rec["img_s"] = x.shape[0] / statistics.median(cs.wall_s(
            lambda: call(x), cs.E2E_TIMES))
    out[what] = rec
d = spec["cpu"]
t0 = time.perf_counter()
call, meta = load_serving_program(d["path"], "cpu")
y = call(torch.load(d["input"]))
out["cpu_s"] = time.perf_counter() - t0
torch.save(y[:d["rows"]], d["output"])
out["modules"] = [m for m in sys.modules if m.startswith((
    "ganreverser_tpu_torch.models", "ganreverser_tpu_torch.cli",
    "ganreverser_tpu_torch.analysis.e2e", "jax", "ganreverser_tpu."))]
print("SERVE " + json.dumps(out))
"""


def quant_counters():
    from ganreverser_tpu_torch.ops import quant
    return {name: getattr(quant, name) for name in INT8_LINES}


def quant_cases(dev, n: int, dims=DIMS, noise_dim: int = NOISE_DIM):
    """(kernel, label, make() -> case) for Q1-Q4 at the int8 legs' shapes
    (G3 and R at ``dims``, latents of ``noise_dim``):
    the quantised operands from seeded f32 tensors, the kernel's call as
    the main path makes it (``with_max`` where a quantiser follows: the
    producer then returns (y, max |y|)), the call without the max, its
    plain version, the library call (torch._int_mm for Q3, its K or M
    zero-padded to a multiple of 8 where cuBLAS needs it; none for the
    others: no PyTorch call computes them), operations and bytes."""
    import torch
    import torch.nn.functional as F
    from ganreverser_tpu_torch.ops import conv_kernel as ck
    from ganreverser_tpu_torch.ops import quant as Q
    from ganreverser_tpu_torch.ops import upsample_conv_kernel as uc
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    c, h, w = dims
    cases = []

    def act_input(shape, relu):
        x = torch.randn(shape, device=dev, generator=gen)
        return Q.quantize_plain(torch.clamp_min(x, 0) if relu else x)

    def conv(label, shape, co, act, pool, with_max=True):
        nb, hh, ww, ci = shape
        xq, xs = act_input(shape, False)
        wq, ws = Q.quantize_plain(torch.randn(3, 3, ci, co, device=dev,
                                              generator=gen), axis=(0, 1, 2))
        b = torch.randn(co, device=dev, generator=gen)
        op = Q.conv_operand(wq)
        oh, ow = (hh // 2, ww // 2) if pool else (hh, ww)

        def make():
            # kernel B's bf16 tile on the same layer (its launch, operands
            # laid out beforehand as the fast R does)
            xb = (xq.float() * xs).to(torch.bfloat16)
            kb = (wq.float() * ws.reshape(1, 1, 1, -1)).to(torch.bfloat16)
            kop = ck.conv3x3_operand(kb, torch.bfloat16)
            ones = torch.ones(co, device=dev)

            def call(m=with_max):
                return Q.quant_conv3x3_same(xq, xs, wq, ws, b, act=act,
                                            pool=pool, operand=op,
                                            with_max=m)
            return {
                "kernel": call, "nomax": lambda: call(False),
                "max": with_max, "device": "quant_conv3x3_s8",
                "plain": lambda: Q.quant_conv3x3_plain(
                    xq, xs, wq, ws, b, act=act, pool=pool),
                "exact": (lambda: Q.quant_conv3x3_same(
                    xq, xs, wq, ws, b, pool=pool, operand=op),
                    lambda: Q.quant_conv3x3_plain(xq, xs, wq, ws, b,
                                                  pool=pool)),
                "bf16": ("B", lambda: ck.launch_conv3x3(
                    xb, kb, ones, b, act=act,
                    pool=pool, name="conv3x3", operand=kop)),
                "library": None,
                "ops": 2 * nb * hh * ww * 9 * ci * co,
                "bytes": _nbytes(xq, xs, op, ws, b) + nb * oh * ow * co * 4}
        cases.append(("quant_conv3x3_same", label, make))

    def upsample(label, shape, co):
        nb, hh, ww, ci = shape
        xq, xs = act_input(shape, True)
        k = torch.randn(3, 3, ci, co, device=dev, generator=gen)
        sc = 0.5 + torch.rand(co, device=dev, generator=gen)
        wq16, ws = Q.quant_phase_weights(k, sc)
        sh = torch.randn(co, device=dev, generator=gen)
        op = Q.phase_operand(wq16)

        def make():
            # kernel U's bf16 tile on the same layer, its operand laid out
            # beforehand as the fast G does
            xb = (xq.float() * xs).to(torch.bfloat16)
            kb = k.to(torch.bfloat16)
            kop = uc.phase_operand(kb, torch.bfloat16)

            def call(m=True):
                return Q.quant_upsample2_conv3x3(xq, xs, wq16, ws, sh,
                                                 operand=op, with_max=m)
            return {
                "kernel": call, "nomax": lambda: call(False), "max": True,
                "device": "quant_upsample2_s8",
                "plain": lambda: Q.quant_upsample2_conv3x3_plain(
                    xq, xs, wq16, ws, sh),
                "exact": None,   # ReLU: the call above is held bitwise
                "bf16": ("U", lambda: uc.launch_upsample2_conv3x3_bn_act(
                    xb, kb, sc, sh, "relu", kop)),
                "library": None,
                "ops": 2 * nb * 4 * hh * ww * 4 * ci * co,
                "bytes": (_nbytes(xq, xs, op, ws, sh)
                          + nb * 4 * hh * ww * co * 4)}
        cases.append(("quant_upsample2_conv3x3", label, make))

    def dense(label, nb, k, m, act, with_max):
        xq, xs = act_input((nb, k), act == "elu")
        wq, ws = Q.quantize_plain(torch.randn(k, m, device=dev,
                                              generator=gen), axis=(0,))
        b = torch.randn(m, device=dev, generator=gen)
        op = Q.dense_operand(wq)
        kp, mp = -(-k // 8) * 8, -(-m // 8) * 8
        xl = F.pad(xq, (0, kp - k)).contiguous()
        wl = F.pad(wq, (0, mp - m, 0, kp - k)).contiguous()

        def call(mx=with_max):
            return Q.quant_dense(xq, xs, wq, ws, b, act=act, operand=op,
                                 with_max=mx)
        cases.append(("quant_dense", label, lambda: {
            "kernel": call, "nomax": lambda: call(False), "max": with_max,
            "device": "quant_dense",
            "plain": lambda: Q.quant_dense_plain(xq, xs, wq, ws, b, act=act),
            "exact": None if act in ("none", "relu") else (
                lambda: Q.quant_dense(xq, xs, wq, ws, b, operand=op),
                lambda: Q.quant_dense_plain(xq, xs, wq, ws, b)),
            "library": lambda: torch._int_mm(xl, wl),
            "ops": 2 * nb * k * m,
            "bytes": _nbytes(xq, xs, op, ws, b) + nb * m * 4}))

    def quantize(label, shape):
        x = torch.randn(shape, device=dev, generator=gen)
        cases.append(("quant_act", label, lambda: {
            "kernel": lambda: Q.quant_act(x),
            "plain": lambda: Q.quantize_plain(x),
            "library": None,
            "ops": 4 * x.numel(),   # |x|, max, divide, round + clip
            "bytes": _nbytes(x) + x.numel() + 4}))

    def one_pass(label, shape):
        # a producer's output and its max, as the producer returns them
        x = torch.randn(shape, device=dev, generator=gen)
        m = x.abs().amax()
        cases.append(("quant_act_max", label, lambda: {
            "kernel": lambda: Q.quant_act_max(x, m),
            "two_launches": lambda: Q.quant_act(x),
            "plain": lambda: Q.quantize_with_max_plain(x, m),
            "library": None,
            "ops": 3 * x.numel(),   # divide, round, clip
            "bytes": _nbytes(x, m) + x.numel() + 4}))

    conv(f"R l0 ({n},{h},{w},{c})->64 elu", (n, h, w, c), 64, "elu", False)
    conv(f"R l4 ({n},{h},{w},64)->64 elu", (n, h, w, 64), 64, "elu", False)
    conv(f"R l8 ({n},{h},{w},64)->64 elu+pool", (n, h, w, 64), 64, "elu",
         True)
    conv(f"R l13 ({n},{h // 2},{w // 2},64)->128 elu",
         (n, h // 2, w // 2, 64), 128, "elu", False)
    conv(f"R l17 ({n},{h // 2},{w // 2},128)->128 elu",
         (n, h // 2, w // 2, 128), 128, "elu", False)
    conv(f"R l21 ({n},{h // 2},{w // 2},128)->128 elu+pool",
         (n, h // 2, w // 2, 128), 128, "elu", True)
    conv(f"G l12 ({n},{h},{w},128)->{c} sigmoid", (n, h, w, 128), c,
         "sigmoid", False, with_max=False)
    upsample(f"G stage 1 ({n},{h // 4},{w // 4},512)->256",
             (n, h // 4, w // 4, 512), 256)
    upsample(f"G stage 2 ({n},{h // 2},{w // 2},256)->128",
             (n, h // 2, w // 2, 256), 128)
    dense(f"G l0 ({n},{noise_dim})->{h * w * 32} relu", n, noise_dim,
          h * w * 32, "relu", True)
    dense(f"R l27 ({n},{h * w * 8})->512 elu", n, h * w * 8, 512, "elu",
          True)
    dense(f"R l31 ({n},512)->{noise_dim}", n, 512, noise_dim, "none", False)
    # the entry quantisers: R's images and G's noise
    quantize(f"R's images ({n},{h},{w},{c}) f32", (n, h, w, c))
    quantize(f"G's noise ({n},{noise_dim}) f32", (n, noise_dim))
    # one pass after a producer: the eight sizes of the ten that follow
    # one, largest first (R l0 and l4, R l13 and l17 share theirs)
    for shape, what in (((n, h, w, 128), "G stage 2"),
                        ((n, h, w, 64), "R l0, l4"),
                        ((n, h // 2, w // 2, 256), "G stage 1"),
                        ((n, h // 4, w // 4, 512), "G l0"),
                        ((n, h // 2, w // 2, 128), "R l13, l17"),
                        ((n, h // 2, w // 2, 64), "R l8"),
                        ((n, h // 4, w // 4, 128), "R l21"),
                        ((n, 512), "R l27")):
        one_pass(f"after {what} {shape} f32", shape)
    return cases


def _s8_exact(name: str, label: str, out, ref, again, exact) -> str:
    """Q1's, Q2's or Q3's checks beyond the tolerance: a second call
    bitwise the first; bitwise the plain version with the activation none
    or relu (``exact``: the same inputs with none, else the call itself)."""
    import torch
    check(torch.equal(again, out), f"{name} {label}: a second call differs "
          "from the first")
    if exact is None:
        check(torch.equal(out, ref), f"{name} {label}: not bitwise the plain "
              "version")
        return "bitwise the plain version and a second call"
    kern, plain = exact
    check(torch.equal(kern(), plain()), f"{name} {label}: with act none not "
          "bitwise the plain version")
    return ("a second call bitwise the first, with act none bitwise the "
            "plain version")


def _max_exact(name: str, label: str, y, m) -> str:
    """A producer's max: a 0-d f32 bitwise max |y| of the output it
    returned, and Q4's one pass from it bitwise quantize_plain(y)."""
    import torch
    from ganreverser_tpu_torch.ops import quant as Q
    check(m.shape == () and torch.equal(m, y.abs().amax()),
          f"{name} {label}: max {m} is not max |y| {y.abs().amax()}")
    q, s = Q.quant_act_max(y, m)
    qp, sp = Q.quantize_plain(y)
    check(torch.equal(q, qp) and torch.equal(s, sp), f"{name} {label}: Q4's "
          "one pass from the producer's max differs from quantize_plain")
    return "; the max bitwise max |y| and Q4's one pass from it bitwise"


def check_quant_ragged(dev, card: str) -> None:
    """Phase 10: Q1, Q2 and Q3 off every tile edge (Q1_RAGGED, Q2_RAGGED,
    Q3_RAGGED) on the card against their plain versions with their max:
    bitwise with none or relu (and with none where the case's act is ELU
    or the sigmoid, which stay within TOL_INT8), a second call bitwise the
    first, the max bitwise max |y|, Q4's one pass from it bitwise."""
    import torch
    from ganreverser_tpu_torch.ops import quant as Q
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    for case in Q1_RAGGED + Q2_RAGGED + Q3_RAGGED:
        if len(case) == 4:
            nb, kk, m, act = case
            xq, xs = Q.quantize_plain(torch.randn(nb, kk, device=dev,
                                                  generator=gen))
            wq, ws = Q.quantize_plain(torch.randn(kk, m, device=dev,
                                                  generator=gen), axis=(0,))
            b = torch.randn(m, device=dev, generator=gen)
            name = "quant_dense"

            def run(a, plain=False, with_max=False):
                fn = Q.quant_dense_plain if plain else Q.quant_dense
                return fn(xq, xs, wq, ws, b, act=a, with_max=with_max)
        else:
            nb, hh, ww, ci, co, act, *pool = case
            xq, xs = Q.quantize_plain(torch.randn(nb, hh, ww, ci, device=dev,
                                                  generator=gen))
            b = torch.randn(co, device=dev, generator=gen)
            k = torch.randn(3, 3, ci, co, device=dev, generator=gen)
            if not pool:
                wq, ws = Q.quant_phase_weights(k, 0.5 + torch.rand(
                    co, device=dev, generator=gen))
                name = "quant_upsample2_conv3x3"

                def run(a, plain=False, with_max=False):
                    fn = (Q.quant_upsample2_conv3x3_plain if plain
                          else Q.quant_upsample2_conv3x3)
                    return fn(xq, xs, wq, ws, b, act=a, with_max=with_max)
            else:
                wq, ws = Q.quantize_plain(k, axis=(0, 1, 2))
                name = "quant_conv3x3_same"

                def run(a, plain=False, with_max=False):
                    fn = (Q.quant_conv3x3_plain if plain
                          else Q.quant_conv3x3_same)
                    return fn(xq, xs, wq, ws, b, act=a, pool=pool[0],
                              with_max=with_max)
        out, mx = run(act, with_max=True)
        torch.cuda.synchronize()
        ref = run(act, plain=True)
        check(out.shape == ref.shape, f"{name} {case}: {tuple(out.shape)} vs "
              f"{tuple(ref.shape)}")
        err = (out - ref).abs().max().item()
        tol = TOL_INT8 * max(1.0, ref.abs().max().item())
        check(err <= tol, f"{name} {case}: max_abs_err {err} > {tol}")
        how = _s8_exact(name, str(case), out, ref, run(act), None if act in (
            "none", "relu") else (lambda: run("none"),
                                  lambda: run("none", plain=True)))
        how += _max_exact(name, str(case), out, mx)
        print(f"[int8] {name} ragged {case}: max_abs_err {err:.3e} (tol "
              f"{tol:.1e}), {how}  [{card}]")


def check_quant_kernels(dev, card: str, n: int = N_CHECK, dims=DIMS,
                        noise_dim: int = NOISE_DIM,
                        tag: str = "int8") -> list:
    """Phase 10: Q1-Q4 against their plain versions on the card at the int8
    legs' shapes; Q1-Q3 also bitwise (``_s8_exact``) with their max
    (``_max_exact``), their device times with and without the max, timed
    beside their __dp4a predecessors' times and B's or U's bf16 kernel on
    the same layer, Q3 beside torch._int_mm, and off every tile edge
    (``check_quant_ragged``); Q4's one pass beside its two launches on the
    same input; records as check_kernels' (dtype "int8"). At another
    ``dims`` (phase 13) the same checks and times at its shapes, without
    the predecessors and the ragged cases."""
    import torch
    main = (dims, noise_dim) == (DIMS, NOISE_DIM)
    records = []
    sums = {name: {"ms": 0.0, "bf16": 0.0, "bound": 0.0, "device": 0.0,
                   "device_nomax": 0.0, "library": 0.0}
            for name in S8_LINES}
    q4 = {"one": 0.0, "two": 0.0, "bound": 0.0}
    for name, label, make in quant_cases(dev, n, dims, noise_dim):
        case = make()
        out = case["kernel"]()
        torch.cuda.synchronize()
        ref = case["plain"]()
        how = ""
        if name in S8_LINES:
            y = out[0] if case["max"] else out
            how = ", " + _s8_exact(name, label, y, ref, (
                case["nomax"]() if case["max"] else case["kernel"]()),
                case["exact"])
            if case["max"]:
                how += _max_exact(name, label, *out)
            out = y
        if name in ("quant_act", "quant_act_max"):
            check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
                  f"{name} {label}: q or scale differ from the plain version")
            check(int(out[0].min()) >= -127, f"{name} {label}: q holds -128")
            err = 0.0
        else:
            check(out.shape == ref.shape and out.dtype == ref.dtype
                  and bool(torch.isfinite(out).all()),
                  f"{name} {label}: {tuple(out.shape)} {out.dtype} vs plain "
                  f"{tuple(ref.shape)} {ref.dtype}")
            err = (out - ref).abs().max().item()
            tol = TOL_INT8 * max(1.0, ref.abs().max().item())
            check(err <= tol, f"{name} {label}: max_abs_err {err} > {tol}")
        del out, ref
        ms, plain_ms = time_ms(case["kernel"]), time_ms(case["plain"])
        lib_ms = (time_ms(case["library"]) if case["library"] is not None
                  else None)
        b_ms, b_by = bound(case["ops"], case["bytes"], "int8")
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        beside = ""
        if name in S8_LINES:
            dev_ms = dev_nomax = 0.0
            if main:  # phase 13 traces nothing (launch_ms)
                dev_ms = launch_ms(case["kernel"], (case["device"],))
                dev_nomax = launch_ms(case["nomax"], (case["device"],))
                mode = "with" if case["max"] else "without"
                beside = (f", device {dev_ms:.4f} ms ({mode} the max; "
                          f"{dev_nomax:.4f} without)")
            bf16_ms = 0.0
            if "bf16" in case:
                which, fn = case["bf16"]
                bf16_ms = time_ms(fn)
                beside += (f", {which}'s bf16 kernel on the layer "
                           f"{bf16_ms:.4f} ms")
            before = next((v for k, v in Q_BEFORE_MS.items()
                           if main and label.startswith(k)), None)
            if before is not None:
                beside += f", the __dp4a kernel {before:.2f} ms"
            for key, v in (("ms", ms), ("bf16", bf16_ms), ("bound", b_ms),
                           ("device", dev_ms), ("device_nomax", dev_nomax),
                           ("library", lib_ms or 0.0)):
                sums[name][key] += v
        if name == "quant_act_max":
            two_ms = time_ms(case["two_launches"])
            beside = f", Q4's two launches on the same input {two_ms:.4f} ms"
            for key, v in (("one", ms), ("two", two_ms), ("bound", b_ms)):
                q4[key] += v
        print(f"[{tag}] {name} {label}: max_abs_err {err:.3e} (q and scale "
              f"bitwise; outputs tol {TOL_INT8:.0e} of scale){how}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, bound "
              f"{b_ms:.4f} ms ({b_by}){beside}  [{card}]")
        records.append({"name": name, "label": label, "dtype": "int8",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": b_ms,
                        "bound_by": b_by})
    for name, s in sums.items():
        what = {S8_LINES[0]: "R's six layers and G's output conv",
                S8_LINES[1]: "G's two stages",
                S8_LINES[2]: "G l0, R l27 and R l31"}[name]
        yard = (f"torch._int_mm {s['library']:.4f} ms" if name == "quant_dense"
                else f"bf16 kernel on the same layers {s['bf16']:.4f} ms")
        was = (f" (the __dp4a kernel {Q_BEFORE_SUMS[name]:.3f} ms), device "
               f"{s['device']:.4f} ms as the main path calls it, "
               f"{s['device_nomax']:.4f} without the max" if main else "")
        print(f"[{tag}] {name} on the int8 tensor cores, {what}: "
              f"{s['ms']:.4f} ms{was}; {yard}, bound {s['bound']:.4f} ms  "
              f"[{card}]")
    was = (f" (the two launches at five sizes before: "
           f"{Q_BEFORE_SUMS['quant_act']:.3f} ms)" if main else "")
    print(f"[{tag}] quant_act_max, Q4's one pass after a producer, at the "
          f"eight sizes: {q4['one']:.4f} ms; Q4's two launches on the same "
          f"inputs {q4['two']:.4f} ms{was}; bound "
          f"{q4['bound']:.4f} ms  [{card}]")
    if main:
        check_quant_ragged(dev, card)
    torch.cuda.empty_cache()
    return records


def check_int8_q4_launches(dev, card: str, gv: dict, rv: dict) -> None:
    """Phase 10: apply_r --int8's stage ② (the int8 G and R over N_MAIN
    latents, batch 256) traced: Q4's device kernels must launch
    Q4_LAUNCHES_A_CHUNK times a chunk."""
    import torch
    from ganreverser_tpu_torch.analysis.pipeline import generate_and_invert
    from ganreverser_tpu_torch.core.prng import seeded_generator
    batch = 256
    chunks = -(-N_MAIN // batch)

    def stage2():
        generate_and_invert(gv, rv, dims=DIMS, n=N_MAIN,
                            noise_dim=NOISE_DIM, noise_method="normal",
                            generator=seeded_generator(1, dev),
                            batch_size=batch, dtype=torch.bfloat16,
                            int8=True)
    stage2()
    counts = device_counts(stage2, Q4_KERNELS)
    per_chunk = sum(counts.values()) / chunks
    check(per_chunk == Q4_LAUNCHES_A_CHUNK, f"apply_r --int8 stage ②: "
          f"{counts} Q4 launches over {chunks} chunks, {per_chunk} a chunk, "
          f"not {Q4_LAUNCHES_A_CHUNK}")
    print(f"[int8] apply_r --int8 stage ② traced, N={N_MAIN} batch {batch}: "
          f"Q4's launches {counts} over {chunks} chunks = {per_chunk:g} a "
          f"chunk (24 before the producers took the max)  [{card}]")


def check_serving(dev, card: str, tmp: str, secs4: dict, rate8: float):
    """Phase 10: export, a fresh process's load, the CPU leg, Q1-Q4, apply_r
    --int8 and the int8 program's recall (see the module docstring).
    Returns (kernel records, Q1-Q4's launches in apply_r --int8 and the
    int8 export's check)."""
    import torch
    from torch.utils import _pytree as pytree
    from ganreverser_tpu_torch.analysis import e2e
    from ganreverser_tpu_torch.analysis.similarity import topk_recall
    from ganreverser_tpu_torch.cli import apply_r, export
    from ganreverser_tpu_torch.models import bridge
    t_phase = time.perf_counter()
    G, R, RF = make_models(dev)
    save = os.path.join(tmp, "logs")
    g_path = save_models(G, R, RF, save)
    gv, rv = bridge.module_variables(G), bridge.module_variables(R)
    del G, R, RF
    n_e2e, b_e2e, k_e2e = SERVE_E2E
    base = ["--G", g_path, "--save", save, "--compute_dtype", "bfloat16",
            "--check"]
    exports = {"invert": ["--batch", str(SERVE_BATCH)],
               "generate": ["--batch", str(SERVE_BATCH)],
               "e2e": ["--N", str(n_e2e), "--batch", str(b_e2e), "--k",
                       str(k_e2e)]}
    done = {what: export.main([*base, "--out", os.path.join(tmp, what),
                               "--what", what, *extra])
            for what, extra in exports.items()}

    # the same inputs through the live legs and through a fresh process
    legs = e2e.fast_legs(DIMS, NOISE_DIM, "normal")
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    c, h, w = DIMS
    inputs = {"invert": torch.rand(SERVE_BATCH, h, w, c, device=dev,
                                   generator=gen).to(torch.bfloat16),
              "generate": torch.randn(SERVE_BATCH, NOISE_DIM, device=dev,
                                      generator=gen),
              "e2e": torch.randn(n_e2e, NOISE_DIM, device=dev, generator=gen)}
    fwd = e2e.make_e2e_forward(None, None, batch_size=b_e2e, k=k_e2e, **legs)
    with torch.no_grad():
        live = {"invert": (legs["r_apply"](rv, inputs["invert"]),),
                "generate": (legs["g_apply"](gv, inputs["generate"]),),
                "e2e": fwd((gv, rv), inputs["e2e"])}
        cpu_want = legs["r_apply"](
            pytree.tree_map(lambda t: t.cpu(), rv),
            inputs["invert"][:SERVE_CPU_ROWS].cpu())
    spec = {"card": {}, "cpu": {
        "path": os.path.join(tmp, "invert"),
        "input": os.path.join(tmp, "invert_in.pt"),
        "output": os.path.join(tmp, "invert_cpu_out.pt"),
        "rows": SERVE_CPU_ROWS}}
    for what, x in inputs.items():
        torch.save(x.cpu(), os.path.join(tmp, f"{what}_in.pt"))
        spec["card"][what] = {"path": os.path.join(tmp, what),
                              "input": os.path.join(tmp, f"{what}_in.pt"),
                              "output": os.path.join(tmp, f"{what}_out.pt")}
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_LOADER, root, json.dumps(spec)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, GANREVERSER_PLATFORM="gpu"))
    check(proc.returncode == 0, f"serving: the loading process failed: "
          f"{proc.stderr[-3000:]}")
    loaded = json.loads(next(line for line in proc.stdout.splitlines()
                             if line.startswith("SERVE "))[6:])
    check(not loaded["modules"], f"serving: the loading process imported "
          f"{loaded['modules']}")
    chunks = n_e2e // b_e2e
    expected = {"invert": {"conv_block": 6, "dense_act": 2},
                "generate": {"upsample2_conv3x3_bn_act": 1,
                             "upsample2_conv3x3_head": 1, "dense_act": 1},
                "e2e": {"upsample2_conv3x3_bn_act": chunks,
                        "upsample2_conv3x3_head": chunks,
                        "conv_block": 6 * chunks,
                        "cosine_scores": -(-n_e2e // E2E_CHUNK),
                        "dense_act": 3 * chunks}}
    lines = []
    for what, want in live.items():
        got = [t.to(dev) for t in torch.load(spec["card"][what]["output"])]
        err, scale = export.max_float_error(got, want)
        tol = TOL_SERVE * max(1.0, scale)
        check(err <= tol and all(a.shape == b.shape for a, b in zip(
            got, want)), f"serving {what}: loaded artifact vs live program "
              f"{err} > {tol}")
        counts = {k: v for k, v in loaded[what]["counts"].items() if v}
        check(counts == expected[what], f"serving {what}: kernels of one "
              f"traced call {counts}, expected {expected[what]}")
        rec = loaded[what]
        lines.append(f"{what}: export {done[what]['export_s']:.2f} s, "
                     f"{done[what]['bytes'] / 1e6:.1f} MB, load "
                     f"{rec['load_s']:.2f} s, first call "
                     f"{rec['first_s']:.2f} s, vs live max_abs_err "
                     f"{err:.3e} (tol {tol:.1e}), kernels of a traced call "
                     f"{counts}")
    emb, v, i = (t.to(dev) for t in torch.load(spec["card"]["e2e"]["output"]))
    topk_line = check_topk("loaded e2e artifact", emb, v, i, k_e2e, TOL_TOPK,
                           f64=True)
    cpu_got = torch.load(spec["cpu"]["output"])
    cpu_err, cpu_scale = export.max_float_error((cpu_got,), (cpu_want,))
    cpu_tol = TOL["bfloat16"] * max(1.0, cpu_scale)
    check(cpu_err <= cpu_tol, f"serving: invert artifact on the CPU vs the "
          f"plain path {cpu_err} > {cpu_tol}")
    for line in lines:
        print(f"[serving] {line}  [{card}]")
    print(f"[serving] loaded e2e artifact (N={n_e2e}, batch {b_e2e}, bf16, "
          f"one CUDA graph in a fresh process): {loaded['e2e']['img_s']:.1f} "
          f"img/s (median of {E2E_TIMES}), phase 8's live graph "
          f"{rate8:.1f} img/s; {topk_line}  [{card}]")
    print(f"[serving] the invert artifact on the CPU: {loaded['cpu_s']:.2f} "
          f"s for {SERVE_BATCH} rows, {SERVE_CPU_ROWS} rows vs the plain "
          f"path max_abs_err {cpu_err:.3e} (tol {cpu_tol:.1e}); the loading "
          f"process imported nothing of models/, cli/, analysis/e2e.py  "
          f"[{card}]")
    del live, emb, v, i

    # Q1-Q4 against their plain versions
    records = check_quant_kernels(dev, card)
    check_int8_q4_launches(dev, card, gv, rv)

    # apply_r --int8, the int8 legs' main path, with phase 4's arguments
    counters = {**kernel_counters(), **quant_counters()}
    for fn in counters.values():
        fn.launches = 0
    out_dir = os.path.join(tmp, "out_int8")
    t0 = time.perf_counter()
    result = apply_r.main(["--G", g_path, "--save", save, "--writeto",
                           out_dir, "--N", str(N_MAIN), "--needles",
                           str(NEEDLES), "--batchSize", "256",
                           "--compute_dtype", "bfloat16", "--int8"])
    whole_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, count in launches.items():
        check(count > 0, f"apply_r --int8: {name} launched no time")
    score_errs = check_main_path(result, out_dir)
    secs = result["seconds"]
    print(f"[serving] apply_r --int8 N={N_MAIN} bf16 batch 256: whole call "
          f"{whole_s:.2f} s; launches {launches}; top-k score error vs plain "
          f"{max(score_errs):.2e}  [{card}]")
    print("[serving] stage seconds, int8 vs phase 4's bf16: " + ", ".join(
        f"{k} {secs[k]:.4f} / {secs4[k]:.4f}" for k in secs) +
        f"; generate+invert {N_MAIN / secs['generate_invert']:.1f} vs "
        f"{N_MAIN / secs4['generate_invert']:.1f} img/s  [{card}]")
    del result
    q_launches = {name: launches[name] for name in INT8_LINES}

    # the int8 program's top-k against the bf16 program's on phase 8's x3
    # weights (a random G ties every score at phase 4's)
    G, R, _, _, gv2, rv2, z = e2e_inputs(dev)
    progs = {label: e2e.make_e2e_program(
        G, R, batch_size=E2E_BATCHES[0], k=E2E_K, needle_chunk=E2E_CHUNK,
        **e2e.fast_legs(DIMS, NOISE_DIM, "normal", int8=int8))
        for label, int8 in (("bf16", False), ("int8", True))}
    (_, _, i_bf), (_, _, i_q) = (progs[k](gv2, rv2, z) for k in progs)
    recall = topk_recall(i_bf.cpu().numpy(), i_q.cpu().numpy())
    check(abs(recall - INT8_RECALL) <= 5e-5, f"int8 e2e program: top-k "
          f"recall against bf16 {recall:.6f}, not {INT8_RECALL}")
    t_q = wall_s(lambda: progs["int8"](gv2, rv2, z), 3)
    print(f"[serving] int8 e2e program (N={E2E_N}, batch {E2E_BATCHES[0]}, "
          f"k={E2E_K}, weights x{E2E_AMPLIFY:g}): top-k recall against the "
          f"bf16 program {recall:.4f} (must be {INT8_RECALL}); graph "
          f"{E2E_N / statistics.median(t_q):.1f} img/s  [{card}]")
    del progs, i_bf, i_q, G, R, gv2, rv2, z
    torch.cuda.empty_cache()

    # export --what e2e --int8 --check, its launches counted
    for fn in quant_counters().values():
        fn.launches = 0
    q8 = export.main([*base, "--out", os.path.join(tmp, "e2e_int8"),
                      "--what", "e2e", "--int8", "--N", str(SERVE_E2E_INT8_N),
                      "--batch", str(b_e2e), "--k", str(k_e2e)])
    for name, fn in quant_counters().items():
        q_launches[name] += fn.launches
    print(f"[serving] export --what e2e --int8 --check (N cut to "
          f"{SERVE_E2E_INT8_N} from {n_e2e}: the trace's time): export "
          f"{q8['export_s']:.2f} s, {q8['bytes'] / 1e6:.1f} MB, check "
          f"max_abs_err {q8['check_err']:.3e} (scale "
          f"{q8['check_scale']:.2e})  [{card}]")
    print(f"[time] phase 10 {time.perf_counter() - t_phase:.1f} s  [{card}]")
    torch.cuda.empty_cache()
    return records, q_launches


# -- phase 11: approximate selection (kernel S) and the two-pass tiled_topk --

APPROX_RECALLS = (0.95, 0.99, 1.0)
APPROX_R = 0.95          # --recall_target's default: the main path's
# kernel S's shapes: label, needles Q, rows N, D of kernel C's scores, k,
# on the main path; apply_r's two searches and the fused program's needle
# chunk (both measures), then one shape of large L at r = 1
APPROX_SHAPES = [("apply_r attributes", NEEDLES, N_MAIN, NOISE_DIM, 100),
                 ("apply_r pixels", NEEDLES, N_MAIN, 3 * 64 * 64, 100),
                 ("e2e needle chunk", E2E_CHUNK, E2E_N, NOISE_DIM, E2E_K),
                 ("e2e pixel chunk", E2E_CHUNK, E2E_N, 3 * 64 * 64,
                  E2E_PIXEL_K)]
APPROX_LARGE = ("large L", E2E_CHUNK, 2 * E2E_N, NOISE_DIM, E2E_K, 1.0)
S_KERNEL = "approx_topk_select_kernel"
TILES = (512, 1024, 2048)


def s_device_times() -> dict:
    """S's device time and kernels a call at phase 11's shapes, by
    ``tools/time_kernels.py --names approx_topk`` in a fresh process
    (traces late in this script's run record some launches or none:
    launch_ms), keyed by its labels."""
    import subprocess
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "time_kernels.py")
    out = subprocess.run([sys.executable, tool, "--names", "approx_topk"],
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"tools/time_kernels.py --names approx_topk: "
          f"rc {out.returncode}: {out.stderr[-2000:]}")
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    return {r["label"]: (r["device_ms"], r["kernels_per_call"])
            for r in rows if r.get("name") == "approx_topk"}


def approx_cases(dev, card: str):
    """Phase 11a: kernel S against its plain version on kernel C's scores,
    bitwise, in one launch, at APPROX_SHAPES x APPROX_RECALLS and the
    large-L shape; at r = 1 the values must be torch.topk's. Prints and
    returns the records (on the main path: r = APPROX_R) and the e2e pixel
    chunk's scores."""
    import torch
    from ganreverser_tpu_torch.ops import approx_topk_kernel as S
    from ganreverser_tpu_torch.ops import topk_kernel
    gen = torch.Generator(device=dev).manual_seed(SEED + 110)
    records, pixel_scores = [], None
    devices = s_device_times()
    cases = [(*shape, r) for shape in APPROX_SHAPES for r in APPROX_RECALLS]
    for label, q, n, d, k, r in cases + [APPROX_LARGE]:
        emb = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
        scores = topk_kernel.cosine_scores(emb, torch.arange(q, device=dev))
        del emb
        plan = S.select_plan(q, n, k, r)
        before = S.approx_topk.launches
        v, i = S.approx_topk(scores, k, r)
        torch.cuda.synchronize()
        check(S.approx_topk.launches == before + 1, f"S {label}: "
              f"{S.approx_topk.launches - before} launches counted")
        pv, pi = S.approx_topk_plain(scores, k, r)
        check(torch.equal(i, pi) and torch.equal(v.view(torch.int32),
                                                 pv.view(torch.int32)),
              f"S {label} Q={q} N={n} k={k} r={r}: differs from the plain "
              "version")
        if r == 1.0:
            check(torch.equal(v, torch.topk(scores, k, dim=1).values),
                  f"S {label} r=1: values differ from torch.topk's")
        dev_ms, kernels = devices.get(f"{label} Q={q} N={n} k={k} r={r}",
                                      (0.0, 0))
        check(kernels == 1, f"S {label} r={r}: {kernels} kernels a call in "
              "a trace, not one")
        ms = time_ms(lambda: S.approx_topk(scores, k, r))
        plain_ms = time_ms(lambda: S.approx_topk_plain(scores, k, r))
        exact_ms = time_ms(lambda: torch.topk(scores, k, dim=1))
        b_ms, b_by = bound(0.0, q * n * 4 + q * k * 12, "float32")
        print(f"[approx] S {label} Q={q} N={n} (C's scores at D={d}) k={k} "
              f"r={r}: L={plan.bins}, cluster {plan.cluster}, keys "
              f"{'on' if plan.keys_on_chip else 'off'} chip, row "
              f"{'staged' if plan.stage_row else 'read'}, one launch; "
              f"indices and values bitwise the plain version; S "
              f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, "
              f"torch.topk {exact_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
              f"  [{card}]")
        records.append({"name": "approx_topk", "label": f"{label} r={r}",
                        "dtype": "float32", "max_abs_err": 0.0, "ms": ms,
                        "device_ms": dev_ms, "plain_ms": plain_ms,
                        "library_ms": exact_ms if r == 1.0 else None,
                        "bound_ms": b_ms,
                        "bound_by": b_by, "on_path": r == APPROX_R
                        and label != APPROX_LARGE[0]})
        if label == "e2e pixel chunk" and r == APPROX_R:
            pixel_scores = scores
        del scores, v, i, pv, pi
    torch.cuda.empty_cache()
    return records, pixel_scores


def check_tiled(scores, card: str, k: int = E2E_PIXEL_K):
    """Phase 11b: tiled_topk at TILES against one torch.topk on the e2e
    pixel chunk's scores: values equal, and the times (ROADMAP item 7's
    A/B)."""
    import torch
    from ganreverser_tpu_torch.analysis import tiled_topk
    ref = torch.topk(scores, k, dim=1)
    parts = [f"torch.topk {time_ms(lambda: torch.topk(scores, k, dim=1)):.4f}"
             " ms"]
    for tile in TILES:
        v, i = tiled_topk(scores, k, tile)
        check(torch.equal(v, ref.values) and torch.equal(
            scores.gather(1, i), v), f"tiled_topk tile {tile}: values differ "
              "from torch.topk's")
        parts.append(f"tile {tile} "
                     f"{time_ms(lambda: tiled_topk(scores, k, tile)):.4f} ms")
    print(f"[approx] tiled_topk vs one torch.topk, Q={scores.shape[0]} "
          f"N={scores.shape[1]} k={k}, values equal (median of 10, CUDA "
          f"events): " + ", ".join(parts) + f"  [{card}]")


def amplify_models(*models) -> None:
    """Every kernel of ``models`` x E2E_AMPLIFY, in place: phase 8's other
    weights as modules, whose checkpoints apply_r reads."""
    import torch
    from ganreverser_tpu_torch.models import bridge
    with torch.no_grad():
        for model in models:
            for leaves in bridge.module_variables(model)["params"].values():
                if "kernel" in leaves:
                    leaves["kernel"].mul_(E2E_AMPLIFY)


def check_approx(dev, card: str, tmp: str):
    """Phase 11 (see the module docstring). Returns S's records and its
    launches on the main path (apply_r --approx, then the approximate
    fused program's first call)."""
    import torch
    from ganreverser_tpu_torch.analysis import e2e
    from ganreverser_tpu_torch.analysis.similarity import topk_recall
    from ganreverser_tpu_torch.cli import apply_r
    from ganreverser_tpu_torch.ops import approx_topk_kernel as S
    from ganreverser_tpu_torch.ops.topk_kernel import cosine_scores_plain
    t_phase = time.perf_counter()
    records, pixel_scores = approx_cases(dev, card)
    check_tiled(pixel_scores, card)
    del pixel_scores

    # apply_r, exact and --approx, on phase 8's x3 weights as checkpoints
    G, R, RF = make_models(dev)
    amplify_models(G, R, RF)
    save = os.path.join(tmp, "logs")
    g_path = save_models(G, R, RF, save)
    del G, R, RF
    counters = {**kernel_counters(), "approx_topk": S.approx_topk}
    runs = {}
    for label, flags in (("exact", []), ("approx", [
            "--approx", "--recall_target", str(APPROX_R)])):
        for fn in counters.values():
            fn.launches = 0
        out_dir = os.path.join(tmp, f"out_{label}")
        t0 = time.perf_counter()
        result = apply_r.main(["--G", g_path, "--save", save, "--writeto",
                               out_dir, "--N", str(N_MAIN), "--needles",
                               str(NEEDLES), "--batchSize", "256",
                               "--compute_dtype", "bfloat16", *flags])
        whole_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        runs[label] = (result, launches, whole_s)
    (exact, _, exact_s), (approx, launches, approx_s) = runs["exact"], \
        runs["approx"]
    for name, count in launches.items():
        check(count > 0, f"apply_r --approx: {name} launched no time")
    check(launches["approx_topk"] == 2, f"apply_r --approx: S launched "
          f"{launches['approx_topk']} times, not once per search")
    check_main_path(approx, os.path.join(tmp, "out_approx"), exact=False)
    check(torch.equal(approx["attributes"], exact["attributes"]),
          "apply_r --approx: the latents differ from the exact run's")
    idx = torch.tensor([(i + 1) * 100 - 1 for i in range(NEEDLES)],
                       device=dev)
    recalls = []
    for what, rows in (("attr_topk", approx["attributes"]),
                       ("pix_topk", approx["images"].reshape(N_MAIN, -1))):
        v, i = approx[what]
        named = (cosine_scores_plain(rows, idx).gather(1, i) - v).abs().max()
        check(named.item() <= TOL_SCORES and bool((v[:, :-1] >= v[:, 1:])
                                                   .all()),
              f"apply_r --approx {what}: values not the scores at their "
              f"indices ({named.item()}) or not descending")
        recalls.append(topk_recall(exact[what][1].cpu().numpy(),
                                   i.cpu().numpy()))
    check(min(recalls) >= APPROX_R - 0.02, f"apply_r --approx: recall "
          f"{recalls} below {APPROX_R} - 0.02")
    s_launches = launches["approx_topk"]
    print(f"[approx] apply_r --approx --recall_target {APPROX_R} N={N_MAIN} "
          f"bf16 batch 256, weights x{E2E_AMPLIFY:g}: whole call "
          f"{approx_s:.2f} s (exact {exact_s:.2f} s); stage ④ "
          f"{approx['seconds']['search']:.4f} s (exact "
          f"{exact['seconds']['search']:.4f} s); launches {launches}; "
          f"top-100 recall against the exact run: attributes "
          f"{recalls[0]:.4f}, pixels {recalls[1]:.4f}  [{card}]")
    del runs, exact, approx

    # the fused program, approximate and exact, both measures, on the x3
    # weights (phase 4's random G ties every score)
    G, R, _, _, gv2, rv2, z = e2e_inputs(dev)

    def program(approx, pixel_k):
        return e2e.make_e2e_program(
            G, R, batch_size=E2E_BATCHES[0], k=E2E_K, needle_chunk=E2E_CHUNK,
            approx=approx, recall_target=APPROX_R, pixel_k=pixel_k,
            **e2e.fast_legs(DIMS, NOISE_DIM, "normal"))

    fused = program(True, E2E_PIXEL_K)
    S.approx_topk.launches = 0
    out = fused(gv2, rv2, z)
    torch.cuda.synchronize()
    first = S.approx_topk.launches
    chunks = -(-E2E_N // E2E_CHUNK)
    check(first == 4 * chunks, f"e2e approx: S launched {first} times in "
          f"the first call, expected {4 * chunks} (warm-up and one replay, "
          f"two searches of {chunks} chunks)")
    s_launches += first
    traced = device_counts(lambda: fused(gv2, rv2, z),
                           {"approx_topk": S_KERNEL})
    check(traced["approx_topk"] == 2 * chunks, f"e2e approx: S kernels in "
          f"a traced replay {traced}, expected {2 * chunks}")
    exact_prog = program(False, E2E_PIXEL_K)
    ref = exact_prog(gv2, rv2, z)
    check(torch.equal(out[0], ref[0]), "e2e approx: the embeddings differ "
          "from the exact program's")
    e_recalls = []
    for j, what in ((2, "attributes"), (4, "pixels")):
        v = out[j - 1]
        check(bool(torch.isfinite(v).all()) and bool(
            (v[:, :-1] >= v[:, 1:]).all()), f"e2e approx {what}: values "
              "non-finite or not descending")
        e_recalls.append(topk_recall(ref[j].cpu().numpy(),
                                     out[j].cpu().numpy()))
    check(min(e_recalls) >= APPROX_R - 0.02, f"e2e approx: recall "
          f"{e_recalls} below {APPROX_R} - 0.02")
    rates = {}
    for label, prog in (("approx, pixel measure", fused),
                        ("exact, pixel measure", exact_prog),
                        ("approx", program(True, 0)),
                        ("exact", program(False, 0))):
        prog(gv2, rv2, z)
        rates[label] = E2E_N / statistics.median(
            wall_s(lambda: prog(gv2, rv2, z), E2E_TIMES))
    del fused, exact_prog, out, ref
    torch.cuda.empty_cache()
    print(f"[approx] fused program N={E2E_N} bf16 batch {E2E_BATCHES[0]} "
          f"k={E2E_K} pixel_k={E2E_PIXEL_K}, weights x{E2E_AMPLIFY:g}, "
          f"approx=True r={APPROX_R}: top-k recall against the exact program"
          f": attributes {e_recalls[0]:.4f}, pixels {e_recalls[1]:.4f}; S "
          f"{first} launches in the first call, {traced['approx_topk']} "
          f"kernels in a traced replay; graph img/s (median of "
          f"{E2E_TIMES}): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                        rates.items()) + f"  [{card}]")
    print(f"[time] phase 11 {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return records, s_launches


# -- phase 12: the parallel layer ------------------------------------------

PAR_RANKS = 2            # ranks spawned on the one card, over gloo
PAR_TP_N = 2048          # rows of the (1, 2) 'model' mesh invert
PAR_NEEDLES = 10         # distributed_cosine_topk's needles (apply_r's)
PAR_TIMEOUT_S = 600      # a spawned rank's limit
HALF_FRACTION = 0.25     # mesh step vs 1 rank, of a rank's own rows' error
BF16_EPS = 2.0 ** -8     # ... or one bf16 rounding, whichever is larger
ADAM_LR = 1e-3           # adam's step bound per element: 2 lr
PARAM_STEP_TOL = 0.1     # a parameter's step off by this of its leaf's
# the kernels each mesh-path run of a rank must launch
PAR_GATES = {"e2e": ("upsample2_conv3x3_bn_act", "upsample2_conv3x3_head",
                     "conv_block", "cosine_scores"),
             "topk": ("cosine_scores", "approx_topk"),
             "r_step": ("fused_dropout",),
             "gan_step": (),
             "tp": ("upsample2_conv3x3_bn_act", "upsample2_conv3x3_head",
                    "conv_block")}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def par_counters() -> dict:
    from ganreverser_tpu_torch.ops import (approx_topk_kernel,
                                           conv_block_kernel, topk_kernel,
                                           upsample_conv_kernel)
    from ganreverser_tpu_torch.ops import dropout_kernel as dk
    uc = upsample_conv_kernel
    return {"upsample2_conv3x3_bn_act": uc.upsample2_conv3x3_bn_act,
            "upsample2_conv3x3_head": uc.upsample2_conv3x3_head,
            "conv_block": conv_block_kernel.conv_block,
            "cosine_scores": topk_kernel.cosine_scores,
            "approx_topk": approx_topk_kernel.approx_topk,
            "fused_dropout": dk.fused_dropout}


def e2e_program(G, R, distributed_mesh=None, pixel_k: int = 0):
    """Phase 8's fused program (batch 128, bf16, k 100, chunk 256, the fast
    legs), or with ``distributed_mesh`` its distributed form."""
    from ganreverser_tpu_torch.analysis import e2e
    kw = dict(batch_size=E2E_BATCHES[0], k=E2E_K, needle_chunk=E2E_CHUNK,
              pixel_k=pixel_k, **e2e.fast_legs(DIMS, NOISE_DIM, "normal"))
    if distributed_mesh is None:
        return e2e.make_e2e_program(G, R, **kw)
    return e2e.make_distributed_e2e_program(G, R, mesh=distributed_mesh, **kw)


def _scale_err(a, b) -> float:
    b = b.float()
    return (a.float() - b).abs().max().item() / max(1.0,
                                                    b.abs().max().item())


def check_parallel_one_rank(dev, card: str, rate8: float, tmp: str):
    """Phase 12a: the distributed program in a one-rank NCCL world against
    phase 8's program on the x3 weights, with and without the pixel
    measure; saves the one-rank results for 12b. Returns its launches."""
    import torch
    from ganreverser_tpu_torch import parallel as par
    check(par.initialize_distributed(f"localhost:{free_port()}", 1, 0),
          "parallel: the one-rank world did not start")
    import torch.distributed as dist
    check(dist.get_backend() == "nccl", f"parallel: one rank on one card "
          f"took backend {dist.get_backend()}, expected nccl")
    launches = {}
    try:
        mesh = par.make_mesh()
        G, R, _, _, gv2, rv2, z = e2e_inputs(dev)
        lines = []
        for pixel_k in (0, E2E_PIXEL_K):
            single = e2e_program(G, R, pixel_k=pixel_k)(gv2, rv2, z)
            program = e2e_program(G, R, mesh, pixel_k)
            out, counts = _launches_of(lambda: program(gv2, rv2, z),
                                       par_counters())
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            emb_err = _scale_err(out[0], single[0])
            check(emb_err <= TOL["bfloat16"], f"parallel 1 rank: embeddings "
                  f"{emb_err} from phase 8's program")
            for v, i, sv, si, what in ((out[1], out[2], single[1],
                                        single[2], "attributes"),
                                       *(((out[3], out[4], single[3],
                                           single[4], "pixels"),)
                                         if pixel_k else ())):
                err = (v - sv).abs().max().item()
                same = int((i == si).all(1).sum())
                checked, bad = _index_mismatch(v, i, sv, si)
                check(err <= TOL_TOPK, f"parallel 1 rank {what}: top-k "
                      f"values {err} from phase 8's program")
                # the attribute search is the one-rank program's, bit for
                # bit; the ring scores the pixels on a corpus of its own
                # rows and block (kernel C may slice D otherwise): indices
                # equal at every position of a unique value
                check(what == "pixels" or same == v.shape[0],
                      f"parallel 1 rank {what}: {v.shape[0] - same} rows "
                      "with other indices")
                check(checked > 0 and bad == 0, f"parallel 1 rank {what}: "
                      f"{bad} rows with another index at a position of a "
                      f"unique value ({checked} positions checked)")
                lines.append(f"{what} (pixel_k {pixel_k}) values "
                             f"max_abs_err {err:.3e}, indices equal on "
                             f"{same} of {v.shape[0]} rows and at all "
                             f"{checked} positions of unique values")
            t = wall_s(lambda: program(gv2, rv2, z), E2E_TIMES)
            print(f"[parallel] 1-rank NCCL world, make_distributed_e2e_"
                  f"program N={E2E_N} bf16 batch {E2E_BATCHES[0]} k={E2E_K} "
                  f"pixel_k={pixel_k}: {E2E_N / statistics.median(t):.1f} "
                  f"img/s (median of {E2E_TIMES}) beside phase 8's graph "
                  f"{rate8:.1f} img/s (pixel_k 0); embeddings max err "
                  f"{emb_err:.3e} of scale  [{card}]")
            if pixel_k:
                torch.save({"emb": single[0], "v": single[1],
                            "i": single[2], "pv": single[3],
                            "pi": single[4]},
                           os.path.join(tmp, "single.pt"))
            del program, out, single
            torch.cuda.empty_cache()
        print(f"[parallel] 1-rank checks: {'; '.join(lines)}; launches "
              f"{launches}  [{card}]")
    finally:
        par.shutdown_distributed()
    return launches


def _capture_grads(opt, log: list):
    from ganreverser_tpu_torch.optim import Optimizer

    def update(grads, state, params):
        log.append([g.detach().clone() for g in grads])
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


def _rounding_leaves(module) -> list:
    """For each of ``module.parameters()``: whether it is the bias of a
    layer that feeds a training-mode BatchNorm directly. The normalisation
    takes every per-channel shift away, so its gradient is zero but for the
    rounding of a sum, and has no scale of its own."""
    from ganreverser_tpu_torch.models.modules import BatchNorm, Sequential
    fed = set()
    for m in module.modules():
        if isinstance(m, Sequential):
            kids = list(m.children())
            for layer, nxt in zip(kids, kids[1:]):
                bias = getattr(layer, "bias", None)
                if isinstance(nxt, BatchNorm) and bias is not None:
                    fed.add(id(bias))
    return [id(p) in fed for p in module.parameters()]


def _leaf_errs(mesh: list, one: list, rounding: list) -> list:
    """Each leaf's error against the one-rank step: the L2 norm of the
    difference over the leaf's own norm, so that a summed or half-batch
    gradient fails whatever its scale; a ``rounding`` leaf's largest
    difference over the largest value of all leaves."""
    top = max((b.float().abs().max().item() for b in one), default=0.0)
    errs = []
    for a, b, r in zip(mesh, one, rounding):
        d = a.float() - b.float()
        if r:
            errs.append(d.abs().max().item() / max(top, 1e-30))
        else:
            errs.append(d.norm().item() / max(b.float().norm().item(), 1e-30))
    return errs


def _step_errors(one: dict, mesh: dict) -> dict:
    """The mesh step against the one-rank step: the loss's relative error,
    the gradients' and buffers' largest leaf errors (_leaf_errs), the
    largest step of a parameter, and the share of parameter elements whose
    step differs from the one-rank step by more than PARAM_STEP_TOL of its
    leaf's largest one-rank step."""
    steps = {t: [a.float() - b.float() for a, b in zip(d["params"],
                                                       d["before"])]
             for t, d in (("one", one), ("mesh", mesh))}
    off = total = 0
    for a, b in zip(steps["mesh"], steps["one"]):
        off += int(((a - b).abs() > PARAM_STEP_TOL * b.abs().max()).sum())
        total += b.numel()
    return {"loss": (mesh["loss"].float() - one["loss"].float()).abs().item()
            / max(one["loss"].float().abs().item(), 1e-30),
            "grads": max(_leaf_errs(mesh["grads"], one["grads"],
                                    one["rounding"]), default=0.0),
            "buffers": max(_leaf_errs(mesh["buffers"], one["buffers"],
                                      [False] * len(one["buffers"])),
                           default=0.0),
            "param_max": max(d.abs().max().item() for d in steps["mesh"]),
            "param_off": off / total}


def _params_of(ts) -> list:
    return [p.detach().clone() for p in ts.module.parameters()]


def _train_state_out(ts, before, loss, grads) -> dict:
    return {"loss": loss, "grads": grads, "before": before,
            "rounding": _rounding_leaves(ts.module), "params": _params_of(ts),
            "buffers": [b.clone() for b in ts.module.buffers()]}


def _launches_of(fn, counters: dict):
    """``fn()`` with every counter set to 0 just before it, and the counts
    read just after it: (its result, the launches of this run alone)."""
    import torch
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items()}


def _index_mismatch(v, i, v_ref, i_ref) -> tuple:
    """Top-k indices against a reference where they are determined: at
    every position but the last whose reference value is unique in its row
    (a tie, also one with the unseen (k+1)-th, may take either index).
    Returns (positions checked, rows with a checked position whose index
    differs); the reference rows must be sorted descending."""
    import torch
    check(bool((v_ref[:, :-1] >= v_ref[:, 1:]).all()),
          "parallel: a reference top-k row is not sorted")
    unique = torch.ones_like(v_ref, dtype=torch.bool)
    unique[:, 1:] &= v_ref[:, 1:] != v_ref[:, :-1]
    unique[:, :-1] &= v_ref[:, :-1] != v_ref[:, 1:]
    unique[:, -1] = False
    bad = (unique & (i != i_ref)).any(1)
    return int(unique.sum()), int(bad.sum())


def _with_half(out: dict, nets=("",)) -> dict:
    """The mesh step's errors against the one-rank step on the whole batch,
    and beside each under ``half_`` those of the one-rank step on this
    rank's rows alone: how far the fault of a rank that steps on its own
    rows moves the step."""
    errs = {}
    for net in nets:
        pre = f"{net}_" if net else ""
        for tag, x in (("", "mesh"), ("half_", "half")):
            for k, v in _step_errors(out[f"one{net}"],
                                     out[f"{x}{net}"]).items():
                errs[f"{tag}{pre}{k}"] = v
    return errs


def rank_r_step(dev, mesh, counters: dict) -> tuple:
    """12b: one R step (bf16, batch 256, ``--dropout kernel``) on the mesh
    against the same step of one rank on the whole batch, beside the step of
    one rank on this rank's rows (_with_half): (errors, the mesh step's
    launches)."""
    import torch
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models import modules, zoo
    from ganreverser_tpu_torch.optim import adam
    from ganreverser_tpu_torch.train.r_loop import make_r_train_step
    from ganreverser_tpu_torch.train.state import TrainState
    bf16 = torch.bfloat16
    G = make_calibrated_g(dev, n_batches=5)
    z = noise_inputs(torch.Generator(device=dev).manual_seed(SEED + 41),
                     TRAIN_BATCH, NOISE_DIM, device=dev)
    out = {}
    rows = mesh.rows(TRAIN_BATCH)
    for tag, m, batch in (("one", None, z), ("half", None, z[rows]),
                          ("mesh", mesh, z[rows])):
        Rm = modules.init_parameters(
            zoo.create_R(DIMS, NOISE_DIM, "normal", dtype=bf16,
                         dropout_impl="kernel"),
            torch.Generator().manual_seed(SEED + 40)).to(dev)
        modules.set_dropout_generator(
            Rm, torch.Generator(device=dev).manual_seed(SEED + 42))
        if m is not None:
            modules.set_data_parallel(Rm, m)
        grads: list = []
        opt = _capture_grads(adam(), grads)
        ts = TrainState.create(Rm, opt)
        before = _params_of(ts)
        step = make_r_train_step(G, dtype=bf16, opt=opt, mesh=m)
        if m is None:
            loss = step(ts, batch)
        else:
            loss, launches = _launches_of(lambda: step(ts, batch), counters)
        out[tag] = _train_state_out(ts, before, loss, grads[-1])
    return _with_half(out), launches


def rank_gan_step(dev, mesh, counters: dict) -> tuple:
    """12b: one G/D batch pair (bf16, batch 256, adam) on the mesh against
    the same pair of one rank on the whole batch, beside the pair of one
    rank on this rank's rows (_with_half): (errors, the mesh pair's
    launches)."""
    import torch
    from ganreverser_tpu_torch.models import modules
    from ganreverser_tpu_torch.optim import adam
    from ganreverser_tpu_torch.parallel import psum
    from ganreverser_tpu_torch.train.adversarial import (
        Confusion, make_adversarial_steps)
    bf16 = torch.bfloat16
    real, zd, zg = _gan_batches(dev, TRAIN_BATCH, 1)[0]
    half = tuple(x[mesh.rows(x.shape[0])] for x in (real, zd, zg))
    out, counts = {}, {}
    for tag, m, (xr, xd, xg) in (("one", None, (real, zd, zg)),
                                 ("half", None, half),
                                 ("mesh", mesh, (real, zd, zg))):
        gs = make_gan(dev, bf16, adam())
        if m is not None:
            for ts in (gs.g, gs.d):
                modules.set_data_parallel(ts.module, m)
        dg, gg = [], []
        d_step, g_step = make_adversarial_steps(
            dtype=bf16, d_optimizer=_capture_grads(adam(), dg),
            g_optimizer=_capture_grads(adam(), gg), mesh=m)
        conf = Confusion.zero(dev)
        before = {"d": _params_of(gs.d), "g": _params_of(gs.g)}

        def pair():
            return d_step(gs, xr, xd, conf), g_step(gs, xg)
        if m is None:
            dl, gl = pair()
        else:
            (dl, gl), launches = _launches_of(pair, counters)
        counts[tag] = conf.counts.float() if m is None else psum(
            conf.counts.float(), m)
        for net, ts, grads, loss in (("d", gs.d, dg, dl), ("g", gs.g, gg, gl)):
            out[f"{tag}{net}"] = _train_state_out(ts, before[net], loss,
                                                  grads[-1])
    errs = _with_half(out, ("d", "g"))
    errs["counts_equal"] = float(torch.equal(counts["one"], counts["mesh"]))
    return errs, launches


def rank_tp_invert(dev, model_mesh, counters: dict) -> tuple:
    """12b: stage ② of PAR_TP_N rows on a (1, 2) mesh, G's and R's big
    kernels cut over 'model' (gathered once per call), against the one-rank
    generate_and_invert on the same generator: (errors, the mesh run's
    launches)."""
    import torch
    from ganreverser_tpu_torch import parallel as par
    from ganreverser_tpu_torch.analysis.distributed import \
        distributed_generate_and_invert
    from ganreverser_tpu_torch.analysis.pipeline import generate_and_invert
    from ganreverser_tpu_torch.models import bridge
    G, R, _ = make_models(dev)
    gv, rv = bridge.module_variables(G), bridge.module_variables(R)
    placed = {}
    for k, v in (("g", gv), ("r", rv)):
        placed[k] = ({"params": par.shard_params(v["params"], model_mesh),
                      "state": v["state"]},
                     {"params": par.param_specs(v["params"], model_mesh),
                      "state": {a: {b: par.P() for b in s}
                                for a, s in v["state"].items()}})
    kw = dict(dims=DIMS, n=PAR_TP_N, noise_dim=NOISE_DIM,
              noise_method="normal", batch_size=TRAIN_BATCH,
              dtype=torch.bfloat16)
    (_, images, attrs), launches = _launches_of(
        lambda: distributed_generate_and_invert(
            placed["g"][0], placed["r"][0], mesh=model_mesh,
            generator=torch.Generator(device=dev).manual_seed(SEED + 43),
            g_specs=placed["g"][1], r_specs=placed["r"][1], **kw), counters)
    _, images1, attrs1 = generate_and_invert(
        gv, rv, generator=torch.Generator(device=dev).manual_seed(SEED + 43),
        **kw)
    local = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        placed["g"][0]["params"]))
    whole = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        gv["params"]))
    return {"images": _scale_err(images, images1),
            "attrs": _scale_err(attrs, attrs1),
            "g_share": local / whole}, launches


def parallel_rank(rank: int, port: int, tmp: str) -> int:
    """Phase 12b, one of PAR_RANKS processes on the one card: its rows of
    the distributed program (x3 weights, pixel_k 100), the distributed
    search exact and approximate, B5's counter base against the whole
    mask, a DP R step, a DP G/D pair and a (1, 2) 'model' mesh invert.
    The launch counts are each mesh-path run's alone (_launches_of): the
    one-rank references and B5's bitwise check count nothing. Writes its
    results to ``<tmp>/rank<r>.pt``."""
    import torch
    from ganreverser_tpu_torch import parallel as par
    from ganreverser_tpu_torch.analysis.distributed import \
        distributed_cosine_topk
    from ganreverser_tpu_torch.ops import dropout_kernel as dk
    # the device as main() set it in the environment the rank inherits
    par.initialize_distributed(f"localhost:{port}", PAR_RANKS, rank)
    import torch.distributed as dist
    res = {"backend": dist.get_backend(), "launches": {}}
    counters = par_counters()
    mesh = par.make_mesh()
    dev = mesh.device
    G, R, _, _, gv2, rv2, z = e2e_inputs(dev)
    rows = mesh.rows(E2E_N)
    program = e2e_program(G, R, mesh, E2E_PIXEL_K)
    out, res["launches"]["e2e"] = _launches_of(
        lambda: program(gv2, rv2, z[rows]), counters)
    t = wall_s(lambda: program(gv2, rv2, z[rows]), 3)
    res["e2e"] = dict(zip(("emb", "v", "i", "pv", "pi"),
                          (x.cpu() for x in out)))
    res["e2e_s"] = statistics.median(t)
    needles = torch.arange(PAR_NEEDLES, device=dev) * (E2E_N // PAR_NEEDLES)
    res["topk"], res["launches"]["topk"] = _launches_of(
        lambda: [tuple(x.cpu() for x in distributed_cosine_topk(
            out[0], needles, E2E_K, mesh, approx=approx))
            for approx in (False, True)], counters)
    del program, out
    torch.cuda.empty_cache()
    x = torch.randn(DROPOUT_SHAPES[0], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 44)).to(torch.bfloat16)
    seed = torch.tensor([DROPOUT_SEEDS[0]], dtype=torch.int32, device=dev)
    r = mesh.rows(x.shape[0])
    part = x[r].contiguous()
    res["b5_bitwise"] = bool(torch.equal(
        dk.fused_dropout(part, seed, 0.5, base=r.start * part[0].numel()),
        dk.fused_dropout_plain(x, seed, 0.5)[r]))
    del x, part
    for what, fn in (("r_step", rank_r_step), ("gan_step", rank_gan_step)):
        res[what], res["launches"][what] = fn(dev, mesh, counters)
    res["tp"], res["launches"]["tp"] = rank_tp_invert(
        dev, par.make_mesh(data=1, model=2), counters)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    par.shutdown_distributed()
    return 0


def _check_step(what: str, e: dict) -> None:
    """Phase 12b's gate on a mesh step's errors (_with_half): each at most
    HALF_FRACTION of the distance of a step on the rank's rows alone, and
    of a summed gradient's 1.0, or one bf16 rounding where that distance is
    nil; adam's step bound on every parameter."""
    for key in [k for k in e if k.endswith(("loss", "grads", "buffers",
                                            "param_off"))
                and not k.startswith("half_")]:
        bound = max(HALF_FRACTION * min(1.0, e[f"half_{key}"]), BF16_EPS)
        check(e[key] <= bound, f"parallel {what} {key}: {e[key]} > {bound}"
              f" ({HALF_FRACTION} of the rank's own rows' "
              f"{e[f'half_{key}']})")
    for key in [k for k in e if k.endswith("param_max")
                and not k.startswith("half_")]:
        # adam's first step is below lr in every element, either way
        check(e[key] <= 2 * ADAM_LR + 1e-6, f"parallel {what} {key}: "
              f"{e[key]} beyond adam's step")


def check_parallel_ranks(dev, card: str, tmp: str) -> dict:
    """Phase 12b: PAR_RANKS processes on the one card over gloo (module
    docstring); their rows against 12a's one-rank results. Returns the
    launches of the ranks' mesh-path runs, summed."""
    import torch
    from ganreverser_tpu_torch.analysis.similarity import (cosine_topk,
                                                           topk_recall)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), str(port), tmp], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(PAR_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAR_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("<dist>"):
                print(f"[parallel] rank {r}: {line}")
        check(p.returncode == 0, f"parallel rank {r} exited {p.returncode}:"
              f"\n{out[-4000:]}")
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
           for r in range(PAR_RANKS)]
    single = torch.load(os.path.join(tmp, "single.pt"))
    gathered = {k: torch.cat([r["e2e"][k] for r in res]) for k in res[0]["e2e"]}
    emb_err = _scale_err(gathered["emb"], single["emb"].cpu())
    check(emb_err <= TOL["bfloat16"], f"parallel {PAR_RANKS} ranks: "
          f"embeddings {emb_err} from the one-rank program")
    lines = []
    for v, i, what in (("v", "i", "attributes"), ("pv", "pi", "pixels")):
        err = (gathered[v] - single[v].cpu()).abs().max().item()
        checked, bad = _index_mismatch(gathered[v], gathered[i],
                                     single[v].cpu(), single[i].cpu())
        check(err <= TOL_TOPK, f"parallel {PAR_RANKS} ranks {what}: top-k "
              f"values {err} from the one-rank program")
        check(checked > 0 and bad == 0, f"parallel {PAR_RANKS} ranks {what}:"
              f" {bad} rows with another index at a position of a unique "
              f"value ({checked} positions checked)")
        lines.append(f"{what} values max_abs_err {err:.3e}, indices equal "
                     f"at all {checked} positions of unique values")
    emb = single["emb"].cpu()
    needles = torch.arange(PAR_NEEDLES) * (E2E_N // PAR_NEEDLES)
    ev, ei = cosine_topk(emb.to(dev), needles.to(dev), E2E_K)
    ev, ei = ev.cpu(), ei.cpu()
    for r in res:
        (xv, xi), (av, ai) = r["topk"]
        err = (xv - ev).abs().max().item()
        check(err <= TOL_TOPK, f"parallel distributed_cosine_topk: values "
              f"{err} from cosine_topk")
        checked, bad = _index_mismatch(xv, xi, ev, ei)
        check(checked > 0 and bad == 0, f"parallel distributed_cosine_topk: "
              f"{bad} rows with another index at a unique value")
        recall = topk_recall(ei.numpy(), ai.numpy())
        check(recall >= 0.95 - 0.02, f"parallel distributed_cosine_topk "
              f"approx: recall {recall}")
        check(r["b5_bitwise"], "parallel: B5 with a counter base differs "
              "from the rows of the whole mask")
        check(r["backend"] == "gloo", f"parallel: {PAR_RANKS} ranks on one "
              f"card took backend {r['backend']}, expected gloo")
        for run, names in PAR_GATES.items():
            for name in names:
                check(r["launches"][run][name] > 0, f"parallel: a rank's "
                      f"{run} run launched {name} no time")
        for what in ("r_step", "gan_step"):
            _check_step(what, r[what])
        check(r["gan_step"]["counts_equal"] == 1.0, "parallel G/D pair: "
              "the confusion counts differ")
        check(r["tp"]["attrs"] <= TOL["bfloat16"]
              and r["tp"]["images"] <= TOL["bfloat16"]
              and r["tp"]["g_share"] < 1.0, f"parallel (1, 2) invert: "
              f"{r['tp']}")
    fmt = lambda d: ", ".join(f"{k} {v:.3e}" for k, v in d.items())  # noqa
    print(f"[parallel] {PAR_RANKS} ranks on one card over gloo, "
          f"{secs:.1f} s with start-up: distributed program N={E2E_N} "
          f"pixel_k {E2E_PIXEL_K} (x3 weights) "
          f"{E2E_N / max(r['e2e_s'] for r in res):.1f} img/s (median of 3); "
          f"embeddings max err {emb_err:.3e} of scale; {'; '.join(lines)}; "
          f"distributed_cosine_topk exact values equal cosine_topk's within "
          f"{TOL_TOPK:.0e} and indices at unique values, approx recall >= "
          f"0.93; B5 with the counter base bitwise the whole mask's rows  "
          f"[{card}]")
    for rank, r in enumerate(res):
        print(f"[parallel] rank {rank}: R step (bf16 b{TRAIN_BATCH}, B5) vs "
              f"one rank: {fmt(r['r_step'])}; G/D pair: {fmt(r['gan_step'])}"
              f"; (1, 2) invert N={PAR_TP_N}: {fmt(r['tp'])}; launches of "
              f"each mesh-path run: " + "; ".join(
                  f"{run} {n}" for run, n in r["launches"].items())
              + f"  [{card}]")
    total = {}
    for r in res:
        for run in r["launches"].values():
            for name, n in run.items():
                total[name] = total.get(name, 0) + n
    return total


def tree_leaves_equal(a: dict, b: dict) -> list:
    """The keys of the leaves of two checkpoint trees that differ."""
    import numpy as np
    diff = []
    for k in a:
        if isinstance(a[k], dict):
            diff += [f"{k}/{d}" for d in tree_leaves_equal(a[k], b[k])]
        elif not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
            diff.append(k)
    return diff


def check_async_save(dev, card: str, tmp: str):
    """Phase 12c: ``cli.train.main`` with --async_save, 2 epochs then one
    more after --network latest, and the same without it, cuDNN held to
    its deterministic algorithms: the checkpoints equal leaf for leaf."""
    import torch
    from ganreverser_tpu_torch.cli import train
    from ganreverser_tpu_torch.io import checkpoint as ckpt
    c, h, w = DIMS
    secs, trees = {}, {}
    with deterministic_cudnn():
        for mode in ("sync", "async"):
            save = os.path.join(tmp, mode)
            base = ["--dataset", "synthetic", "--save", save, "--height",
                    str(h), "--width", str(w), "--noiseDim", str(NOISE_DIM),
                    "--batchSize", str(TRAIN_BATCH), "--compute_dtype",
                    "bfloat16", "--N_epoch", str(GAN_EPOCH_BATCHES),
                    "--saveFreq", "1", "--noplot", "--nopretraining"] + (
                        ["--async_save"] if mode == "async" else [])
            t0 = time.perf_counter()
            for extra in (["--epochs", "2"],
                          ["--epochs", "3", "--network", "latest"]):
                train.main(base + extra)
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t0
            trees[mode] = ckpt.load_checkpoint(ckpt.adversarial_name(save))
    diff = tree_leaves_equal(trees["async"][0], trees["sync"][0])
    check(not diff, f"async_save: checkpoint leaves differ: {diff[:5]}")
    check(trees["async"][2]["plot_data"] == trees["sync"][2]["plot_data"]
          and trees["async"][2]["epoch"] == 3, "async_save: the loss "
          "history or the epoch differs")
    check(trees["async"][1]["async_save"], "async_save: not in the config")
    print(f"[parallel] train --async_save, 2 + 1 epochs of "
          f"{GAN_EPOCH_BATCHES} batches (b{TRAIN_BATCH} bf16, 3x64x64): "
          f"checkpoint equal leaf for leaf to the run without it; "
          f"{secs['async']:.2f} s against {secs['sync']:.2f} s  [{card}]")


def check_native(card: str):
    """Phase 12d: the host image ops (native/imageops.cc), built with g++,
    against their numpy paths at a realistic batch: 256 CelebA-sized
    218x178 images resized to 64x64, the colour conversions and a 32x32
    grid of 1,024 64x64 faces; host milliseconds of each."""
    import numpy as np
    from ganreverser_tpu_torch.data import colorspace as cs
    from ganreverser_tpu_torch.data import dataset
    from ganreverser_tpu_torch.native import imageops
    check(imageops.available(), f"native: the image ops did not build: "
          f"{imageops._LIBRARY.failure}")
    rng = np.random.default_rng(SEED)
    big = rng.random((256, 218, 178, 3), np.float32)
    faces = rng.random((1024, 64, 64, 3), np.float32)

    def host_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    cases = [("resize 256x218x178 -> 64x64",
              lambda: imageops.resize_bilinear_batch(big, 64, 64),
              lambda: dataset.resize_bilinear_numpy(big, 64, 64), 1e-5),
             ("rgb2y", lambda: imageops.rgb2y_native(faces),
              lambda: cs.rgb2y(faces), 1e-5),
             ("rgb2yuv", lambda: imageops.rgb2yuv_native(faces),
              lambda: cs.rgb2yuv(faces), 1e-5),
             ("yuv2rgb", lambda: imageops.yuv2rgb_native(faces),
              lambda: cs.yuv2rgb(faces), 1e-4),
             ("grid 32x32", lambda: imageops.assemble_grid(faces, 32, 32),
              lambda: _numpy_grid(faces, 32, 32), 0.0)]
    parts = []
    for label, native_fn, numpy_fn, tol in cases:
        a, b = native_fn(), numpy_fn()
        err = float(np.abs(a - b).max())
        check(err <= tol * max(1.0, float(np.abs(b).max())),
              f"native {label}: {err} from numpy")
        parts.append(f"{label} err {err:.1e}, {host_ms(native_fn):.2f} ms "
                     f"(numpy {host_ms(numpy_fn):.2f} ms)")
    x = faces.copy()
    check(imageops.normalize_pm1_inplace(x) and np.array_equal(
        x, np.clip(faces * 2 - 1, -1, 1)), "native normalize differs")
    print(f"[parallel] native image ops ({imageops._LIBRARY.path().name}, "
          f"built with g++ at their first use) against numpy, host times "
          f"(median of 3): {'; '.join(parts)}")


def _numpy_grid(images, gh: int, gw: int):
    """utils/grids.py's numpy path (no epoch strip)."""
    import numpy as np
    n, ih, iw, c = images.shape
    grid = np.zeros((gh * ih, gw * iw, c), np.float32)
    for i in range(min(n, gh * gw)):
        gy, gx = divmod(i, gw)
        grid[gy * ih:(gy + 1) * ih, gx * iw:(gx + 1) * iw] = images[i]
    return grid


# -- phase 13: BASELINE.json's configs 1 and 5 --------------------------------


class Config(NamedTuple):
    dims: tuple          # (C, H, W) of G3 and R
    noise_dim: int
    apply_n: int         # apply_r --N
    apply_batch: int     # apply_r --batchSize
    refine_steps: int    # apply_r --refine_steps
    e2e_batch: int       # the fused program's batch


# BASELINE.json configs[0] ("Grayscale 32x32 faces, z=32: G+R forward
# inversion, batch 64") and configs[4] ("128x128 RGB, z=256 with
# gradient-based latent optimization"); apply_r's N at config 5 cut from
# 10,000 to 2,560 (the phase's time; its fused program keeps 10,240)
CONFIGS = {"config1": Config((1, 32, 32), 32, 10_000, 64, 0, 64),
           "config5": Config((3, 128, 128), 256, 2_560, 256, 5, 128)}
# the bf16 kernels of the configs' paths held in phase 13 (B, U, U's head
# and C by check_kernels; K, Q1-Q4 and S by their own checks)
CONFIG_KERNELS = ("conv_block", "upsample2_conv3x3_bn_act",
                  "upsample2_conv3x3_head", "cosine_scores")


def kmeans_at(dev, card: str, tag: str, n: int, d: int) -> dict:
    """Kernel K's whole run at apply_r's shape of a config (N latents of
    D, K = 20, 15 iterations in one launch), held as phase 3 holds it
    (``lloyd_case``); its record."""
    import torch
    from ganreverser_tpu_torch.ops import kmeans_kernel as kk
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn(n, d, device=dev, generator=gen)
    c = x[torch.randperm(n, device=dev, generator=gen)[:KMEANS_K]]
    err, tol, flipped, run_err = lloyd_case(x, c, KMEANS_ITERS)
    ms = time_ms(lambda: kk.kmeans_lloyd(x, c, KMEANS_ITERS))
    plain_ms = time_ms(lambda: kk.kmeans_lloyd_plain(x, c, KMEANS_ITERS))
    b_ms, b_by = bound(KMEANS_ITERS * (2 * n * KMEANS_K * d + n * d),
                       4 * (n * d + 2 * KMEANS_K * d + KMEANS_K), "float32")
    label = f"({n},{d}) K={KMEANS_K}, {KMEANS_ITERS} iterations"
    print(f"[{tag}] kmeans_lloyd {label} float32, one launch: sums "
          f"max_abs_err {err:.3e} (tol {tol:.1e}), {flipped} near-tie rows "
          f"assigned otherwise, centroids vs the plain run {run_err:.3e}; "
          f"bitwise repeatable; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})  [{card}]")
    return {"name": "kmeans_lloyd", "label": label, "dtype": "float32",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def approx_at(dev, card: str, tag: str, cfg: Config) -> list:
    """Kernel S on kernel C's scores at a config's searches (apply_r's two,
    the fused program's needle chunks), r = 0.95 and 1: one launch a call
    (its counter), indices and values bitwise the plain version, at r = 1
    the values torch.topk's; its records."""
    import torch
    from ganreverser_tpu_torch.ops import approx_topk_kernel as S
    from ganreverser_tpu_torch.ops import topk_kernel
    gen = torch.Generator(device=dev).manual_seed(SEED + 110)
    c, h, w = cfg.dims
    records = []
    for label, q, n, d in (("apply_r attributes", NEEDLES, cfg.apply_n,
                            cfg.noise_dim),
                           ("apply_r pixels", NEEDLES, cfg.apply_n, c * h * w),
                           ("e2e needle chunk", E2E_CHUNK, E2E_N,
                            cfg.noise_dim),
                           ("e2e pixel chunk", E2E_CHUNK, E2E_N, c * h * w)):
        emb = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
        scores = topk_kernel.cosine_scores(emb, torch.arange(q, device=dev))
        del emb
        for r in (APPROX_R, 1.0):
            before = S.approx_topk.launches
            v, i = S.approx_topk(scores, E2E_K, r)
            torch.cuda.synchronize()
            check(S.approx_topk.launches == before + 1, f"{tag} S {label}: "
                  f"{S.approx_topk.launches - before} launches counted")
            pv, pi = S.approx_topk_plain(scores, E2E_K, r)
            check(torch.equal(i, pi) and torch.equal(
                v.view(torch.int32), pv.view(torch.int32)), f"{tag} S "
                f"{label} Q={q} N={n} r={r}: differs from the plain version")
            if r == 1.0:
                check(torch.equal(v, torch.topk(scores, E2E_K, dim=1).values),
                      f"{tag} S {label} r=1: values differ from torch.topk's")
            ms = time_ms(lambda: S.approx_topk(scores, E2E_K, r))
            plain_ms = time_ms(lambda: S.approx_topk_plain(scores, E2E_K, r))
            exact_ms = time_ms(lambda: torch.topk(scores, E2E_K, dim=1))
            b_ms, b_by = bound(0.0, q * n * 4 + q * E2E_K * 12, "float32")
            plan = S.select_plan(q, n, E2E_K, r)
            print(f"[{tag}] approx_topk {label} Q={q} N={n} (C's scores at "
                  f"D={d}) k={E2E_K} r={r}: L={plan.bins}, cluster "
                  f"{plan.cluster}, one launch, bitwise the plain version; S "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.topk "
                  f"{exact_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})  [{card}]")
            records.append({"name": "approx_topk", "label": f"{label} r={r}",
                            "dtype": "float32", "max_abs_err": 0.0, "ms": ms,
                            "plain_ms": plain_ms,
                            "library_ms": exact_ms if r == 1.0 else None,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "on_path": r == APPROX_R})
        del scores
    torch.cuda.empty_cache()
    return records


def q3_extremes(dev, card: str, tag: str, k: int, m: int = 512) -> None:
    """Q3 at R l27 of a config with every operand at +-127 (rows 0 and 1
    all +127 and all -127 against an all +127 column): the sums reach
    127^2 K, through the s32 accumulator and the K split's s32 sum;
    bitwise the plain version."""
    import torch
    from ganreverser_tpu_torch.ops import quant as Q
    gen = torch.Generator(device=dev).manual_seed(SEED + 131)
    x = torch.where(torch.rand(N_CHECK, k, device=dev, generator=gen) < 0.5,
                    -1.0, 1.0)
    x[0], x[1] = 1.0, -1.0
    w = torch.where(torch.rand(k, m, device=dev, generator=gen) < 0.5,
                    -1.0, 1.0)
    w[:, 0] = 1.0
    xq, xs = Q.quantize_plain(x)
    wq, ws = Q.quantize_plain(w, axis=(0,))
    b = torch.zeros(m, device=dev)
    _, splits = Q.dense_plan(N_CHECK, k, m)
    out = Q.quant_dense(xq, xs, wq, ws, b)
    torch.cuda.synchronize()
    check(torch.equal(out, Q.quant_dense_plain(xq, xs, wq, ws, b)),
          f"{tag} Q3 at K={k} with +-127 operands: not bitwise the plain "
          "version")
    print(f"[{tag}] quant_dense ({N_CHECK},{k})x({k},{m}) every operand "
          f"+-127, {splits} K splits: bitwise the plain version, the sums "
          f"reaching {127 * 127 * k:,} of 2^31 - 1 = {2 ** 31 - 1:,}  "
          f"[{card}]")


def config_kernels(dev, card: str, tag: str, cfg: Config) -> list:
    """Phase 13a: the kernels of a config's paths against their plain
    versions at its shapes: B, U, U's head and C at phase 3's tolerances
    (f32 and bf16, timed in bf16), K, Q1-Q4 and S bitwise as in phases
    3, 10 and 11, D within phase 3's dense_close."""
    records = check_kernels(dev, card, N_CHECK, cfg.apply_n, cfg.dims,
                            cfg.noise_dim, CONFIG_KERNELS, ("bfloat16",),
                            tag)
    records.append(kmeans_at(dev, card, tag, cfg.apply_n, cfg.noise_dim))
    records += check_quant_kernels(dev, card, N_CHECK, cfg.dims,
                                   cfg.noise_dim, tag)
    c, h, w = cfg.dims
    q3_extremes(dev, card, tag, h * w * 8)
    records += approx_at(dev, card, tag, cfg)
    records += check_dense(dev, card, dense_layers(cfg.dims, cfg.noise_dim),
                           tag)
    return records


def config_apply_r(tag: str, cfg: Config, g_path: str, save: str,
                   out_dir: str, flags: list, counters: dict):
    """``cli.apply_r.main`` at a config, its counters set to 0 just before
    and read just after. Returns (result, launches, seconds)."""
    from ganreverser_tpu_torch.cli import apply_r
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = apply_r.main(["--G", g_path, "--save", save, "--writeto",
                           out_dir, "--N", str(cfg.apply_n), "--needles",
                           str(NEEDLES), "--batchSize", str(cfg.apply_batch),
                           "--compute_dtype", "bfloat16", "--refine_steps",
                           str(cfg.refine_steps), *flags])
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, count in launches.items():
        check(count > 0, f"{tag} apply_r {' '.join(flags) or 'bf16'}: {name} "
              "launched no time")
    return result, launches, seconds


def config_analysis(dev, card: str, tag: str, cfg: Config, tmp: str,
                    launches: dict) -> None:
    """Phase 13b: apply_r at a config (bf16 with the fixer-R, then --int8
    and --approx on the same checkpoints), phase 4's checks on each (the
    searches against the scores in f64); the recalls of --int8 and
    --approx against bf16; then fast vs plain in f32 on 512 rows, and the
    refinement of 512 of the images from R's latents: no image's loss may
    rise. Adds the runs' launches to ``launches``."""
    import torch
    from ganreverser_tpu_torch.analysis.similarity import topk_recall
    from ganreverser_tpu_torch.models import bridge, fastpath
    from ganreverser_tpu_torch.ops import approx_topk_kernel as S
    G, R, RF = make_models(dev, cfg.dims, cfg.noise_dim)
    save = os.path.join(tmp, "logs")
    g_path = save_models(G, R, RF, save, cfg.dims, cfg.noise_dim)
    runs = {}
    for label, flags, extra in (
            ("bf16", [], {}), ("int8", ["--int8"], quant_counters()),
            ("approx", ["--approx", "--recall_target", str(APPROX_R)],
             {"approx_topk": S.approx_topk})):
        out_dir = os.path.join(tmp, f"out_{label}")
        result, counts, seconds = config_apply_r(
            tag, cfg, g_path, save, out_dir, flags,
            {**kernel_counters(), **extra})
        errs = check_main_path(result, out_dir, cfg.apply_n, NEEDLES,
                               cfg.noise_dim, exact=label != "approx",
                               f64=True)
        if label == "approx":
            check(counts["approx_topk"] == 2, f"{tag} apply_r --approx: S "
                  f"launched {counts['approx_topk']} times, not once per "
                  "search")
        for name, count in counts.items():
            launches[name] += count
        secs = result["seconds"]
        print(f"[{tag}] apply_r {' '.join(flags) or 'bf16'} N={cfg.apply_n} "
              f"{cfg.dims} noise {cfg.noise_dim} --batchSize "
              f"{cfg.apply_batch} --refine_steps {cfg.refine_steps}, with "
              f"the fixer-R: whole call {seconds:.2f} s; stage seconds "
              + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
              + f"; generate+invert {cfg.apply_n / secs['generate_invert']:.1f}"
              f" img/s; launches {counts}"
              + (f"; top-k scores vs f64 {max(errs):.2e}" if errs else "")
              + f"  [{card}]")
        runs[label] = {k: result[k] for k in ("attr_topk", "pix_topk",
                                              "images", "attributes")}
        del result
    recalls = {label: [topk_recall(runs["bf16"][what][1].cpu().numpy(),
                                   runs[label][what][1].cpu().numpy())
                       for what in ("attr_topk", "pix_topk")]
               for label in ("int8", "approx")}
    print(f"[{tag}] top-100 recall against the bf16 run (reported, no gate): "
          + "; ".join(f"{label} attributes {r[0]:.4f}, pixels {r[1]:.4f}"
                      for label, r in recalls.items()) + f"  [{card}]")
    images = runs["bf16"]["images"][:N_COMPARE]
    del runs
    img_err, z_err, zf_err = compare_paths(G, R, RF, dev, N_COMPARE,
                                           cfg.dims, cfg.noise_dim)
    print(f"[{tag}] fast vs plain module path, f32, {N_COMPARE} rows: images "
          f"max_abs_err {img_err:.3e}, latents {z_err:.3e}, fixer latents "
          f"(same mask) {zf_err:.3e}  [{card}]")
    with torch.inference_mode():
        z0 = fastpath.make_fast_inverter(cfg.dims, cfg.noise_dim, "normal")(
            bridge.module_variables(R), images)
    loss0, loss1, chunk_err, refine_s = check_refine(G, images, z0)
    print(f"[{tag}] refine {N_COMPARE} of apply_r's images from R's latents, "
          f"{REFINE_STEPS} adam steps, f32 module G: mean pixel MSE "
          f"{loss0:.4e} -> {loss1:.4e}, no image rose; {refine_s:.3f} s; "
          f"chunked vs one chunk on 256 rows max_abs_err {chunk_err:.3e}  "
          f"[{card}]")
    del G, R, RF
    torch.cuda.empty_cache()


def config_e2e(dev, card: str, tag: str, cfg: Config, launches: dict):
    """Phase 13c: the fused program at a config (N = 10,240, its batch,
    k = 100, needle chunk 256), pixel_k 0 and 100: each first call counted
    (every kernel must launch) with its peak device memory, one more replay
    adding exactly the chunks' launches and bitwise the first call, the
    top-k against the plain search (attributes) and against the search in
    f64 on the serial program's images (pixels) as phase 8 holds them;
    img/s of warm calls.
    Adds the first calls' launches to ``launches``."""
    import torch
    from ganreverser_tpu_torch.analysis import e2e
    from ganreverser_tpu_torch.core.prng import noise_inputs
    from ganreverser_tpu_torch.models import bridge
    from ganreverser_tpu_torch.ops import (conv_block_kernel, dense_kernel,
                                           topk_kernel,
                                           upsample_conv_kernel as uc)
    counters = {"upsample2_conv3x3_bn_act": uc.upsample2_conv3x3_bn_act,
                "upsample2_conv3x3_head": uc.upsample2_conv3x3_head,
                "conv_block": conv_block_kernel.conv_block,
                "cosine_scores": topk_kernel.cosine_scores,
                "dense_act": dense_kernel.dense_act}
    n = E2E_N
    G, R, _ = make_models(dev, cfg.dims, cfg.noise_dim)
    gv, rv = bridge.module_variables(G), bridge.module_variables(R)
    z = noise_inputs(torch.Generator(device=dev).manual_seed(SEED + 30), n,
                     cfg.noise_dim, "normal", device=dev)
    legs = e2e.fast_legs(cfg.dims, cfg.noise_dim, "normal")
    generate = e2e.make_serial_programs(
        G, R, batch_size=cfg.e2e_batch, k=E2E_K, needle_chunk=E2E_CHUNK,
        **legs)[0]
    chunks = -(-n // cfg.e2e_batch)
    lines, out = [], None
    for pixel_k in (0, E2E_PIXEL_K):
        prog = e2e.make_e2e_program(G, R, batch_size=cfg.e2e_batch, k=E2E_K,
                                    needle_chunk=E2E_CHUNK, pixel_k=pixel_k,
                                    **legs)
        for fn in counters.values():
            fn.launches = 0
        first, first_s, peak = first_call(lambda: prog(gv, rv, z))
        counts = {name: fn.launches for name, fn in counters.items()}
        for name in counters:
            check(counts[name] > 0, f"{tag} e2e pixel_k={pixel_k}: kernel "
                  f"{name} launched no time in the first call")
        for name, count in counts.items():
            launches[name] += count
        again = prog(gv, rv, z)
        torch.cuda.synchronize()
        per_replay = {name: fn.launches - counts[name]
                      for name, fn in counters.items()}
        expected = {"upsample2_conv3x3_bn_act": chunks,
                    "upsample2_conv3x3_head": chunks,
                    "conv_block": 6 * chunks,
                    "cosine_scores": -(-n // E2E_CHUNK) * (2 if pixel_k
                                                          else 1),
                    "dense_act": 3 * chunks}  # G l0, R l27, R l31
        check(per_replay == expected, f"{tag} e2e pixel_k={pixel_k}: "
              f"launches per replay {per_replay}, expected {expected}")
        check(all(torch.equal(a, b) for a, b in zip(again, first)),
              f"{tag} e2e pixel_k={pixel_k}: a second replay differs from "
              "the first")
        emb = first[0]
        check(tuple(emb.shape) == (n, cfg.noise_dim) and bool(
            torch.isfinite(emb).all()), f"{tag} e2e: embeddings "
              f"{tuple(emb.shape)} or non-finite")
        if out is not None:
            check(torch.equal(emb, out[0]), f"{tag} e2e: the pixel "
                  "program's embeddings differ")
        line = check_topk(f"{tag} attributes", emb, first[1], first[2],
                          E2E_K, TOL_TOPK)
        if pixel_k:
            images = generate(gv, z)
            line = check_topk(f"{tag} pixels", images.reshape(n, -1),
                              first[3], first[4], pixel_k, TOL_TOPK,
                              f64=True)
            del images
        t = wall_s(lambda: prog(gv, rv, z), E2E_TIMES)
        lines.append(f"pixel_k={pixel_k}: graph "
                     f"{n / statistics.median(t):.1f} img/s "
                     f"(median of {E2E_TIMES}: {statistics.median(t):.4f} s; "
                     f"first call {first_s:.2f} s, peak device memory "
                     f"{peak / 2 ** 30:.3f} GiB); launches per replay "
                     f"{per_replay}; {line}")
        out = first
        del prog, again, first
        torch.cuda.empty_cache()
    for line in lines:
        print(f"[{tag}] fused program N={n} {cfg.dims} noise {cfg.noise_dim} "
              f"bf16 batch {cfg.e2e_batch} k={E2E_K} chunk {E2E_CHUNK}, {line}"
              f"  [{card}]")
    del generate, out, G, R
    torch.cuda.empty_cache()


def config_table(tag: str, records: list, launches: dict, card: str):
    """One line per kernel of a config's paths: its wrapper times at the
    config's shapes summed (bf16; K and S f32, S at the main path's r;
    Q1-Q4 int8), its plain version's and library call's, its bound and its
    launches on the config's paths."""
    for name, count in launches.items():
        recs = [r for r in records if r["name"] == name
                and r.get("on_path", True)]
        libs = [r["library_ms"] for r in recs]
        lib = ("none" if None in libs
               else f"{sum(libs):.4f} ms")
        print(f"[{tag}] kernel {name}: {sum(r['ms'] for r in recs):.4f} ms "
              f"over {len(recs)} shape(s), plain "
              f"{sum(r['plain_ms'] for r in recs):.4f} ms, library {lib}, "
              f"bound {sum(r['bound_ms'] for r in recs):.4f} ms ("
              f"{max(recs, key=lambda r: r['bound_ms'])['bound_by']}), "
              f"max_abs_err {max(r['max_abs_err'] for r in recs):.3e}, "
              f"launches {count}  [{card}]")


def check_configs(dev, card: str) -> dict:
    """Phase 13: BASELINE.json's configs 1 and 5 through the port's main
    path (see the module docstring). Every kernel
    must launch on each config's paths. Returns the launches of the
    configs' paths."""
    import torch
    t_phase = time.perf_counter()
    total = {name: 0 for name in (*kernel_counters(), *quant_counters(),
                                  "upsample2_conv3x3_head", "approx_topk")}
    for tag, cfg in CONFIGS.items():
        launches = dict.fromkeys(total, 0)
        t0 = time.perf_counter()
        recs = config_kernels(dev, card, tag, cfg)
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            config_analysis(dev, card, tag, cfg, tmp, launches)
        t2 = time.perf_counter()
        config_e2e(dev, card, tag, cfg, launches)
        for name, count in launches.items():
            check(count > 0, f"{tag}: kernel {name} launched no time on the "
                  "config's paths")
            total[name] += count
        config_table(tag, recs, launches, card)
        print(f"[{tag}] seconds: kernels {t1 - t0:.1f}, apply_r and the "
              f"comparisons {t2 - t1:.1f}, fused program "
              f"{time.perf_counter() - t2:.1f}  [{card}]")
        torch.cuda.empty_cache()
    print(f"[time] phase 13 {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return total


def main(configs_only: bool = False) -> int:
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
        for line in ptxas_lines(log.read_text()):
            print(f"[build] {line}")
    gmma = check_hgmma(lib_path)
    print("[build] SASS guard, HGMMA instructions per bf16 kernel (by BN): "
          + ", ".join(f"{n} {gmma[n]}" for n in (*WGMMA_KERNELS,
                                                  *DENSE_WGMMA))
          + "; IGMMA (s8 wgmma) per int8 kernel: " + ", ".join(
              f"{n} {gmma[n]}" for n in S8_KERNELS) + "; none in " +
          ", ".join((*INT8_CUDA_CORE_KERNELS, DENSE_SUM)) +
          "; no DP4A in any kernel")
    wide = {n: c for n, c in sass_hgmma(lib_path, "IMAD.WIDE").items()
            if "fused_dropout_pack_kernel" in n}
    check(len(wide) == 2, f"SASS: {len(wide)} instances of "
          "fused_dropout_pack_kernel, expected f32 and bf16")
    print("[build] B5's pack kernel, 64-bit IMAD.WIDE instructions (address "
          "arithmetic per 16-byte pack; the hash is 32-bit): " +
          ", ".join(f"{n} {c}" for n, c in sorted(wide.items())))
    from ganreverser_tpu_torch.ops.conv_operands import tile_plan
    print("[build] tile plans (BH, BW, BN, BK, stages, shared bytes): " +
          "; ".join(f"{label} {tuple(tile_plan(*shape))}"
                    for label, *shape in MAIN_CONV_LAYERS + [
                        (lab, h, w, c, co) for lab, (h, w, c), co, _, _
                        in D2_B6_LAYERS]))
    _, h7, w7, c7, co7 = CONVBN_SHAPE
    print(f"[build] B7 and B8 tile plans: B7 conv_stats {CONVBN_SHAPE[1:]} "
          f"(f32 staged tile) {tuple(tile_plan(h7, w7, c7, co7, 4))}; "
          + "; ".join(f"B8 {label} {tuple(tile_plan(*shape))}"
                      for label, *shape in MAIN_CONV_LAYERS
                      if label.startswith("G stage")))

    if configs_only:  # phases 1, 2 and 13 (--configs)
        check_configs(dev, card)
        print(f"[time] the whole run {time.perf_counter() - t_start:.1f} s  "
              f"[{card}]")
        return 0

    # 3. kernels against their plain versions
    records = check_kernels(dev, card)
    records.append(check_kmeans(dev, card))
    records.append(check_dropout(dev, card))
    records += check_conv_stats(dev, card)
    records += check_probe_kernels(dev, card)
    fir_record, fir_launches = check_fir(dev, card)
    records.append(fir_record)
    records += check_dense(dev, card)

    # 4. the main path at full width
    G, R, RF = make_models(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        save, out_dir = os.path.join(tmp, "logs"), os.path.join(tmp, "out")
        g_path = save_models(G, R, RF, save)
        result, launches, seconds = run_main_path(g_path, save, out_dir)
        for name, count in launches.items():
            check(count > 0, f"kernel {name} launched no time in the main "
                  "path")
        check(launches["kmeans_lloyd"] == 1,
              f"kmeans_lloyd launched {launches['kmeans_lloyd']} times for "
              f"the {KMEANS_ITERS} Lloyd iterations of one run, not once")
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
        for name, count in check_pretraining(
                dev, card, tmp,
                ckpt.adversarial_name(os.path.join(tmp, "gan"))).items():
            launches[name] = launches.get(name, 0) + count
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
    # 8. the fused generate -> invert -> top-k program at full width
    t8 = time.perf_counter()
    launches8, rate8 = check_e2e(dev, card)
    for name, count in launches8.items():
        launches[name] = launches.get(name, 0) + count
    t9 = time.perf_counter()
    # 9. the Torch7 import, then apply_r and train on the imported files
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name, count in check_t7_import(dev, card, tmp).items():
            launches[name] += count
    t10 = time.perf_counter()
    # 10. serving: export, load, the CPU leg, Q1-Q4, apply_r --int8
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        q_records, q_launches = check_serving(dev, card, tmp, secs, rate8)
    records += q_records
    launches.update(q_launches)
    t11 = time.perf_counter()
    # 11. approximate selection (kernel S) and the two-pass tiled_topk
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        s_records, launches["approx_topk"] = check_approx(dev, card, tmp)
    records += s_records
    t12 = time.perf_counter()
    # 12. the parallel layer: a one-rank NCCL world, ranks sharing the card
    # over gloo, --async_save, the native image ops
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for phase in (check_parallel_one_rank(dev, card, rate8, tmp),
                      check_parallel_ranks(dev, card, tmp)):
            for name, count in phase.items():
                launches[name] += count
        check_async_save(dev, card, tmp)
    check_native(card)
    t13 = time.perf_counter()
    # 13. BASELINE.json's configs 1 and 5 through the main path
    for name, count in check_configs(dev, card).items():
        launches[name] += count
    print(f"[time] phases 6 and 7 {t8 - t6:.1f} s (7: {secs7:.1f} s), phase "
          f"8 {t9 - t8:.1f} s, phase 9 {t10 - t9:.1f} s, phase 10 "
          f"{t11 - t10:.1f} s, phase 11 {t12 - t11:.1f} s, phase 12 "
          f"{t13 - t12:.1f} s, phase 13 {time.perf_counter() - t13:.1f} s, "
          f"the whole run {time.perf_counter() - t_start:.1f} s  [{card}]")

    sources = {"conv_block": ("ganreverser_tpu_torch/csrc/conv_block.cu",
                              "ganreverser_tpu/ops/conv_block_kernel.py:86"),
               "upsample2_conv3x3_bn_act": (
                   "ganreverser_tpu_torch/csrc/upsample_conv.cu",
                   "ganreverser_tpu/ops/upsample_conv_kernel.py:122"),
               "cosine_scores": ("ganreverser_tpu_torch/csrc/cosine_scores.cu",
                                 "ganreverser_tpu/ops/topk_kernel.py:69"),
               "kmeans_lloyd": ("ganreverser_tpu_torch/csrc/kmeans.cu",
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
                            "benchmarks/tpu_pallas_probe.py:80"),
               # Q1-Q4 replace XLA ops of the JAX package's int8 legs
               "quant_conv3x3_same": ("ganreverser_tpu_torch/csrc/quant.cu",
                                      "ganreverser_tpu/ops/quant.py:60"),
               "quant_upsample2_conv3x3": (
                   "ganreverser_tpu_torch/csrc/quant.cu",
                   "ganreverser_tpu/models/fastpath.py:282"),
               "quant_dense": ("ganreverser_tpu_torch/csrc/quant.cu",
                               "ganreverser_tpu/ops/quant.py:77"),
               "quant_act": ("ganreverser_tpu_torch/csrc/quant.cu",
                             "ganreverser_tpu/ops/quant.py:43"),
               # Q4's one pass after an int8 producer, the same JAX op
               "quant_act_max": ("ganreverser_tpu_torch/csrc/quant.cu",
                                 "ganreverser_tpu/ops/quant.py:43"),
               # S replaces jax.lax.approx_max_k in _select_topk (XLA)
               "approx_topk": ("ganreverser_tpu_torch/csrc/approx_topk.cu",
                               "ganreverser_tpu/analysis/similarity.py:34"),
               # StyleGAN2 exists only in the port: no JAX op to replace
               "fir_filter": ("ganreverser_tpu_torch/csrc/fir.cu",
                              "none: cuDNN's depthwise convolutions"),
               # kernel D: the fast forwards' dense layers, which the JAX
               # package leaves to XLA
               "dense_act": ("ganreverser_tpu_torch/csrc/dense.cu",
                             "none: an f32 torch.matmul and three passes")}
    launches["fir_filter"] = fir_launches
    f32_lines = ("kmeans_lloyd", "add_one", "times_two", "approx_topk")
    kernels = []
    for name, (source, replaces) in sources.items():
        # the main path's dtype (bf16; kmeans and two probes run in f32),
        # summed over the path's shapes (the head's C = 3 row: G_prev is
        # rgb); B, U, C and K's launches are apply_r's and the fused e2e
        # program's first call's (phases 4, 8 and 9), S's (f32 scores) those
        # of apply_r --approx and the approximate e2e program's first call
        # (phase 11, r = 0.95), B5's those of the three
        # train_r runs, B6's those of the three train runs and the sample run,
        # the head's those of the two pretrain_prev runs and the e2e
        # program's, B7-B9's those of their probes; Q1-Q4's (int8) those
        # of apply_r --int8 and the int8 e2e export's check (phase 10);
        # the FIR filter's (bf16 compute dtype, f32 sums) those of one
        # forward and backward of config F at batch 8 (phase 3); D's, as
        # B's, those of apply_r and the fused e2e program's first call
        recs = [r for r in records if r["name"] == name and r["dtype"] == (
            "float32" if name in f32_lines else "int8" if name in INT8_LINES
            else "bfloat16") and r.get("on_path", True)]
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
        if sys.argv[1:2] == ["--parallel-rank"]:  # phase 12b's ranks
            sys.exit(parallel_rank(int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4]))
        sys.exit(main(configs_only=sys.argv[1:2] == ["--configs"]))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
