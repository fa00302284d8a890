"""Fast eval-mode G / R / D forwards through the hand-written kernels — the
counterparts of ganreverser_tpu/models/fastpath.py's ``make_fast_generator``
and ``make_fast_inverter``, and of D2's ``D.apply(v, x, train=False)``.

They consume the standard variable trees of create_G3 / create_R_default
(``{"params", "state"}``, here as tensors on the compute device; see
``models/bridge.to_torch``). G and R are :class:`FastForward` objects: a
``prepare`` step folds each BatchNorm into a per-channel f32 scale/shift,
rounds the weights to the compute dtype and lays them out for the
kernels, and ``run`` is the forward on those operands; a call does both.
They run:

  G: z -> Dense(+BN folded)+ReLU                      [kernel D]
       -> upsample2+conv3x3+BN+ReLU (512->256)       [kernel U]
       -> upsample2+conv3x3+BN+ReLU (256->128)
          -> conv3x3 (128->C) + Sigmoid               [U's fused head]

  R: images -> [conv64+BN+ELU x3 + pool]             [kernel B]
            -> [conv128+BN+ELU x3 + pool]            [kernel B]
            -> Dense(+BN folded)+ELU -> Dense (+Tanh for uniform)
                                                      [kernel D x2]

  D: images -> [conv3x3 + PReLU] x2 + pool          [kernel B6 x2]
            -> left:  conv5x5 + PReLU + pool          [F.conv2d]
               right: [conv3x3 + PReLU] + pool,
                      [conv3x3 + PReLU] x2 + pool     [kernel B6 x3]
            -> Dense + PReLU per branch, Dense + PReLU, Dense + Sigmoid
                                                      [kernel D x4]

where the JAX package leaves the dense layers and D's 5x5 conv to XLA
outside any kernel; G's Co=C head is the JAX kernel's fused final head
(``upsample2_conv3x3(..., final_kernel=...)``). In bf16 each dense layer
is one call of kernel D (ops/dense_kernel.py): the f32 sums of the
bf16-rounded operands, the shift (a folded BatchNorm's or the bias), the
activation where it precedes the rounding (G's ReLU, R's ELU, R's tanh)
and one rounding to bf16, the rounding points of the f32 product it
replaced; D's PReLUs and sigmoid follow the rounding, as before. In f32
the dense layers stay the plain f32 product (``dense_act_plain``): kernel
D is bf16 only. Their f32 precision is pinned by the compute dtype
(core/precision.py), not by the process-wide TF32 flags. On CUDA tensors
the kernels launch; on CPU tensors their plain versions run.

The fixer-R (``make_fast_fixer``) is R behind an always-on input dropout:
its mask is drawn outside the kernels, so the fixer runs on kernel B too.

``make_fast_inverter_int8`` and ``make_fast_generator_int8`` are the int8
legs (ops/quant.py), the counterparts of the JAX package's
``make_fast_inverter_int8`` and ``make_fast_generator_xla_int8``: BatchNorm
folded into the weights, which are quantised per output channel once in
``prepare``; per call each layer's f32 input is quantised per tensor
(kernel Q4) and runs on the int8 kernels, activations in f32 between them.
Every layer but the last returns the max |y| its epilogue took, so the
next layer's Q4 is one pass (``quant_act_max``); the first layer's input
has no int8 producer and takes Q4's two launches:

  G: z -> int8 Dense(+BN)+ReLU                        [Q4, Q3]
       -> 2x int8 upsample2+conv3x3(+BN)+ReLU          [Q4 one pass, Q2]
       -> int8 conv3x3 (128->C) + Sigmoid              [Q4 one pass, Q1]
  R: images -> 2x (3x int8 conv3x3(+BN)+ELU, pool)    [Q4, Q1; the pool in
                                                        the third's epilogue]
            -> int8 Dense(+BN)+ELU -> int8 Dense (+Tanh)
                                                      [Q4 one pass, Q3]
"""
from __future__ import annotations

import torch

from ..ops.conv_block_kernel import conv_block
from ..ops import quant
from ..ops.conv_kernel import conv3x3_bn_act, conv3x3_operand, fold_batchnorm
from ..ops.dense_kernel import dense_act, dense_act_plain, dense_operand
from ..ops.upsample_conv import conv_nhwc
from ..ops.upsample_conv_kernel import (head_operand, phase_operand,
                                        upsample2_conv3x3_bn_act)
from .modules import apply_dropout, dropout_keep_mask

Dims = tuple  # (C, H, W)

FIXER_DROPOUT = 0.5  # the fixer-R's input dropout rate (models.lua:399-406)


class FastForward:
    """A fast forward in two steps: ``prepare(variables)`` folds each
    BatchNorm into an f32 scale/shift, rounds the weights to the compute
    dtype and lays them out as the kernels read them, once;
    ``run(prepared, x)`` is the forward on those operands. Calling it,
    ``f(variables, x)``, does both, so a caller that runs the same weights
    over many chunks prepares once and runs per chunk (analysis/e2e.py)."""

    def __init__(self, prepare, run):
        self.prepare = prepare
        self.run = run

    def __call__(self, variables, x):
        return self.run(self.prepare(variables), x)


def _dense_operand(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A dense (K, M) kernel (a BatchNorm folded in) as ``run`` reads it,
    made once: in bf16 kernel D's (M, K') operand; in f32 the kernel
    rounded to ``dtype`` and held in f32, what ``modules.dense`` makes of
    it on every call (widening R's (32,768 x 512) kernel per chunk cost
    the fused e2e program about 4 % of its img/s on an H100; PERF.md)."""
    if dtype == torch.bfloat16:
        return dense_operand(k)
    return k.to(dtype).float()


def _dense_act(x: torch.Tensor, k: torch.Tensor, shift: torch.Tensor,
               act: str, dtype: torch.dtype) -> torch.Tensor:
    """``act(modules.dense(x, k) + shift)`` rounded once to ``dtype``, on
    :func:`_dense_operand`'s ``k``: kernel D in bf16, the plain f32
    product in f32; bitwise the module's arithmetic on the CPU."""
    if dtype == torch.bfloat16:
        return dense_act(x, k, shift, act)
    return dense_act_plain(x, k, shift, act, dtype)


def make_fast_generator(dims: Dims, noise_dim: int,
                        dtype: torch.dtype = torch.bfloat16) -> FastForward:
    """Returns ``generate(g_variables, z) -> images`` (a
    :class:`FastForward`) equal to ``create_G3(...)`` in evaluation on the
    same weights; images are NHWC in ``dtype``. The second upsample stage
    and the 128->C conv + sigmoid are one call of U's fused head, with the
    rounding points of a separate head (stage 2's output rounded to
    ``dtype``, f32 sums of the head); on the card it took under half the
    time of U and a cuDNN head at every size measured (PERF.md)."""
    c, h, w = dims
    sh, sw = h // 4, w // 4

    def prepare(variables):
        p, s = variables["params"], variables["state"]
        # the kernels' layouts where they launch; the plain versions on the
        # CPU read the HWIO kernels
        on_card = p["l0"]["kernel"].is_cuda
        scale0, shift0 = fold_batchnorm(p["l1"], s["l1"], p["l0"]["bias"])
        stages = []
        for i, (conv, bn) in enumerate((("l5", "l6"), ("l9", "l10"))):
            scale, shift = fold_batchnorm(p[bn], s[bn], p[conv]["bias"])
            k = p[conv]["kernel"].to(dtype)
            stage = {"kernel": k, "scale": scale, "shift": shift,
                     "operand": phase_operand(k, dtype) if on_card else None}
            if i == 1:
                fk = p["l12"]["kernel"]
                stage.update(final_kernel=fk, final_bias=p["l12"]["bias"],
                             final_act="sigmoid", final_operand=head_operand(
                                 fk, dtype, 2 * sh, 2 * sw, k.shape[2])
                             if on_card else None)
            stages.append(stage)
        return {"k0": _dense_operand(
                    p["l0"]["kernel"].float() * scale0[None, :], dtype),
                "shift0": shift0, "stages": stages}

    def run(prep, z):
        # Dense + folded BN + ReLU (models.lua:115-117)
        y = _dense_act(z, prep["k0"], prep["shift0"], "relu", dtype)
        x = y.reshape(z.shape[0], sh, sw, 512)
        # two fused upsample+conv+BN+ReLU stages (models.lua:121-130), the
        # second carrying the output conv + sigmoid (models.lua:132-133)
        for stage in prep["stages"]:
            x = upsample2_conv3x3_bn_act(x, act="relu", **stage)
        return x

    return FastForward(prepare, run)


# R's two conv blocks: (conv, BatchNorm) layer names
R_BLOCKS = ((("l0", "l1"), ("l4", "l5"), ("l8", "l9")),
            (("l13", "l14"), ("l17", "l18"), ("l21", "l22")))


def make_fast_inverter(dims: Dims, noise_dim: int, noise_method: str,
                       dtype: torch.dtype = torch.bfloat16) -> FastForward:
    """Returns ``invert(r_variables, images) -> z_hat`` (a
    :class:`FastForward`) equal to the plain ``create_R_default(...)`` in
    evaluation on the same weights; z_hat is in ``dtype``."""
    if noise_method not in ("normal", "uniform"):
        raise ValueError(noise_method)

    def prepare(variables):
        p, s = variables["params"], variables["state"]
        on_card = p["l0"]["kernel"].is_cuda  # as in the generator
        prep = {"blocks": []}
        for layers in R_BLOCKS:
            block = {"kernels": [], "scales": [], "shifts": []}
            for conv, bn in layers:
                sc, sh_ = fold_batchnorm(p[bn], s[bn], p[conv]["bias"])
                block["kernels"].append(p[conv]["kernel"].to(dtype))
                block["scales"].append(sc)
                block["shifts"].append(sh_)
            block["operands"] = ([conv3x3_operand(k, dtype)
                                  for k in block["kernels"]]
                                 if on_card else None)
            prep["blocks"].append(block)
        scd, shd = fold_batchnorm(p["l28"], s["l28"], p["l27"]["bias"])
        prep.update(kd=_dense_operand(
                        p["l27"]["kernel"].float() * scd[None, :], dtype),
                    shd=shd, k31=_dense_operand(p["l31"]["kernel"], dtype),
                    b31=p["l31"]["bias"])
        return prep

    def run(prep, images):
        # two blocks of 3x [conv + BN + ELU] + maxpool2 (models.lua:409-440)
        x = images.to(dtype).contiguous()
        for block in prep["blocks"]:
            x = conv_block(x, act="elu", pool=True, **block)
        # head: Dense(+BN folded)+ELU -> Dense, + Tanh for uniform noise
        # (models.lua:446-454)
        x = x.reshape(x.shape[0], -1)
        y = _dense_act(x, prep["kd"], prep["shd"], "elu", dtype)
        return _dense_act(y, prep["k31"], prep["b31"],
                          "none" if noise_method == "normal" else "tanh",
                          dtype)

    return FastForward(prepare, run)


def make_fast_inverter_int8(dims: Dims, noise_dim: int, noise_method: str,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> FastForward:
    """Returns ``invert(r_variables, images) -> z_hat`` (a
    :class:`FastForward`), the plain R in evaluation with every conv and
    dense layer in int8 x int8 -> int32 on folded-BN weights (the JAX
    package's ``make_fast_inverter_int8``): an approximation of
    :func:`make_fast_inverter`; z_hat is in ``dtype``."""
    if noise_method not in ("normal", "uniform"):
        raise ValueError(noise_method)

    def prepare(variables):
        p, s = variables["params"], variables["state"]
        on_card = p["l0"]["kernel"].is_cuda  # the kernels' layouts there
        layers = []
        for block in R_BLOCKS:
            for i, (conv, bn) in enumerate(block):
                sc, sh_ = fold_batchnorm(p[bn], s[bn], p[conv]["bias"])
                wq, ws, b = quant.fold_quantize_conv(p[conv]["kernel"], sc,
                                                     sh_)
                layers.append({"wq": wq, "w_scale": ws, "bias": b,
                               "pool": i == len(block) - 1,
                               "operand": (quant.conv_operand(wq)
                                           if on_card else None)})
        scd, shd = fold_batchnorm(p["l28"], s["l28"], p["l27"]["bias"])
        dense = [quant.fold_quantize_dense(p["l27"]["kernel"], scd, shd),
                 quant.fold_quantize_dense(
                     p["l31"]["kernel"],
                     torch.ones((), device=p["l31"]["kernel"].device),
                     p["l31"]["bias"])]
        return {"layers": layers,
                "dense": [{"wq": wq, "w_scale": ws, "bias": b,
                           "operand": (quant.dense_operand(wq)
                                       if on_card else None)}
                          for wq, ws, b in dense]}

    def run(prep, images):
        # two blocks of 3x [conv + BN + ELU] + maxpool2 (models.lua:409-440);
        # each layer's output is quantised from the max its epilogue took
        xq, xs = quant.quant_act(images.float())
        for layer in prep["layers"]:
            y, m = quant.quant_conv3x3_same(
                xq, xs, layer["wq"], layer["w_scale"], layer["bias"],
                act="elu", pool=layer["pool"], operand=layer["operand"],
                with_max=True)
            xq, xs = quant.quant_act_max(y, m)
        # head: Dense(+BN folded)+ELU -> Dense (models.lua:446-451)
        d27, d31 = prep["dense"]
        y, m = quant.quant_dense(xq.reshape(xq.shape[0], -1), xs, d27["wq"],
                                 d27["w_scale"], d27["bias"], act="elu",
                                 operand=d27["operand"], with_max=True)
        xq, xs = quant.quant_act_max(y, m)
        x = quant.quant_dense(xq, xs, d31["wq"], d31["w_scale"], d31["bias"],
                              operand=d31["operand"])
        if noise_method != "normal":
            x = torch.tanh(x)  # models.lua:452-454
        return x.to(dtype)

    return FastForward(prepare, run)


def make_fast_generator_int8(dims: Dims, noise_dim: int,
                             dtype: torch.dtype = torch.bfloat16
                             ) -> FastForward:
    """Returns ``generate(g_variables, z) -> images`` (a
    :class:`FastForward`), G3 in evaluation with its dense layer, both
    upsample stages (kernel U's phase convs, the 16 phase taps quantised
    per output channel) and its output conv in int8 x int8 -> int32 (the
    JAX package's ``make_fast_generator_xla_int8``, whose lhs-dilated 4x4
    kernel holds the same taps); images NHWC in ``dtype``."""
    c, h, w = dims
    sh, sw = h // 4, w // 4

    def prepare(variables):
        p, s = variables["params"], variables["state"]
        on_card = p["l0"]["kernel"].is_cuda
        scale0, shift0 = fold_batchnorm(p["l1"], s["l1"], p["l0"]["bias"])
        wq0, ws0, b0 = quant.fold_quantize_dense(p["l0"]["kernel"], scale0,
                                                 shift0)
        stages = []
        for conv, bn in (("l5", "l6"), ("l9", "l10")):
            scale, shift = fold_batchnorm(p[bn], s[bn], p[conv]["bias"])
            wq16, ws = quant.quant_phase_weights(p[conv]["kernel"], scale)
            stages.append({"wq16": wq16, "w_scale": ws, "shift": shift,
                           "operand": (quant.phase_operand(wq16)
                                       if on_card else None)})
        wq3, ws3 = quant.quantize_plain(p["l12"]["kernel"], axis=(0, 1, 2))
        return {"dense": {"wq": wq0, "w_scale": ws0, "bias": b0,
                          "operand": (quant.dense_operand(wq0)
                                      if on_card else None)},
                "stages": stages,
                "head": {"wq": wq3, "w_scale": ws3,
                         "bias": p["l12"]["bias"].float(),
                         "operand": (quant.conv_operand(wq3)
                                     if on_card else None)}}

    def run(prep, z):
        # Dense + folded BN + ReLU (models.lua:115-117); each producer's
        # output is quantised from the max its epilogue took
        d = prep["dense"]
        zq, zs = quant.quant_act(z.float())
        y, m = quant.quant_dense(zq, zs, d["wq"], d["w_scale"], d["bias"],
                                 act="relu", operand=d["operand"],
                                 with_max=True)
        xq, xs = quant.quant_act_max(y, m)
        xq = xq.reshape(z.shape[0], sh, sw, 512)
        # two upsample + conv + BN + ReLU stages (models.lua:121-130)
        for st in prep["stages"]:
            y, m = quant.quant_upsample2_conv3x3(
                xq, xs, st["wq16"], st["w_scale"], st["shift"], act="relu",
                operand=st["operand"], with_max=True)
            xq, xs = quant.quant_act_max(y, m)
        # final 3x3 conv + sigmoid (models.lua:132-133)
        hd = prep["head"]
        y = quant.quant_conv3x3_same(xq, xs, hd["wq"], hd["w_scale"],
                                     hd["bias"], act="sigmoid",
                                     operand=hd["operand"])
        return y.to(dtype)

    return FastForward(prepare, run)


def _unshift_layers(tree: dict) -> dict:
    """``l<i>`` -> ``l<i-1>`` at the top of each of ``params``/``state``:
    the fixer's layer indices, one past the plain R's (its l0 is the
    dropout, which has no variables)."""
    return {part: {f"l{int(k[1:]) - 1}": v for k, v in tree[part].items()}
            for part in ("params", "state")}


def make_fast_fixer(dims: Dims, noise_dim: int, noise_method: str,
                    dtype: torch.dtype = torch.bfloat16):
    """Returns ``invert(rf_variables, images, generator) -> z_hat`` equal to
    ``create_R(..., fixer=True)`` in evaluation with ``l0.generator`` in the
    same state: a Bernoulli(0.5) keep mask is drawn from ``generator``
    (``modules.dropout_keep_mask``, the module's draw), the survivors are
    doubled, and the kernel-B inverter runs on the fixer's variables with
    their layer indices shifted back by one. Each call draws a fresh mask,
    as the reference's nn.Dropout does on every forward; ``keep=`` gives
    the mask instead (a rank's rows of a mask drawn for more rows,
    analysis/distributed.py). As a :class:`FastForward`, it comes in two
    steps: ``invert_fixer.prepare(rf_variables)`` (the shift and R's
    ``prepare``, once) and ``invert_fixer.run(prepared, images,
    generator, keep=None)``, which draws the mask per call."""
    invert = make_fast_inverter(dims, noise_dim, noise_method, dtype)

    def prepare(variables):
        return invert.prepare(_unshift_layers(variables))

    def run(prep, images, generator=None, keep=None):
        if keep is None:
            keep = dropout_keep_mask(images.shape, FIXER_DROPOUT, generator,
                                     images.device)
        return invert.run(prep, apply_dropout(images, keep, FIXER_DROPOUT))

    def invert_fixer(variables, images, generator=None, keep=None):
        return run(prepare(variables), images, generator, keep)

    invert_fixer.prepare, invert_fixer.run = prepare, run
    return invert_fixer


def make_fast_discriminator(dims: Dims, dtype: torch.dtype = torch.bfloat16
                            ) -> FastForward:
    """Returns ``rate(d_variables, images) -> (N, 1)`` (a
    :class:`FastForward`), probabilities in ``dtype``, D2 in evaluation
    (``create_D2(...)`` under ``.eval()``, the dropouts the identity) on
    the same weights. Five of D2's six convolutions run on kernel B6 with
    scale 1, shift = the conv bias and the PReLU slope read from its (1,)
    parameter on the device; the pool that follows three of them is fused.
    The 5x5 conv of the left branch and the dense layers (kernel D in
    bf16) keep the module path's arithmetic: f32 sums of ``dtype``-rounded
    operands, the bias added in f32, one rounding, then PReLU in
    ``dtype``. ``prepare`` rounds the kernels to ``dtype`` once."""
    c, h, w = dims
    if h % 8 or w % 8:
        raise ValueError(f"D2 needs H and W divisible by 8, got {h}x{w}")

    def prelu(x, alpha):
        return torch.where(x >= 0, x, alpha.to(x.dtype) * x)

    def prepare(variables):
        p = variables["params"]
        left, right = p["l3"]["b0"], p["l3"]["b1"]

        def b6(nxn):
            """create_D2's conv + PReLU block ``nxn`` (its l0, l1)."""
            k = nxn["l0"]["kernel"]
            return {"kernel": k.to(dtype),
                    "scale": torch.ones(k.shape[-1], device=k.device),
                    "shift": nxn["l0"]["bias"],
                    "prelu_alpha": nxn["l1"]["alpha"]}

        def lin(layer, act=None):
            return {"k": _dense_operand(layer["kernel"], dtype),
                    "b": layer["bias"],
                    "alpha": None if act is None else act["alpha"]}

        return {"stem": (b6(p["l0"]), b6(p["l1"])),
                "left": {"kernel": left["l0"]["l0"]["kernel"].to(dtype),
                         "bias": left["l0"]["l0"]["bias"],
                         "alpha": left["l0"]["l1"]["alpha"]},
                "right": (b6(right["l0"]), b6(right["l2"]),
                          b6(right["l3"])),
                "dense": {"left": lin(left["l3"], left["l4"]),
                          "right": lin(right["l6"], right["l7"]),
                          "l4": lin(p["l4"], p["l5"]), "l7": lin(p["l7"])}}

    def dense_prelu(x, d):
        return prelu(_dense_act(x, d["k"], d["b"], "none", dtype),
                     d["alpha"])

    def run(prep, images):
        stem, left, right, dn = (prep["stem"], prep["left"], prep["right"],
                                 prep["dense"])
        # stem: two conv + PReLU blocks, the second with the pool (l0-l2)
        x = conv3x3_bn_act(images.to(dtype).contiguous(), act="prelu",
                           **stem[0])
        x = conv3x3_bn_act(x, act="prelu", pool=True, **stem[1])
        n = x.shape[0]
        # left branch: 5x5 conv + PReLU + pool, Dense + PReLU (l3.b0)
        y = (conv_nhwc(x, left["kernel"], 2, dtype)
             + left["bias"]).to(dtype)
        y = prelu(y, left["alpha"])
        y = y.reshape(n, h // 4, 2, w // 4, 2, -1).amax(dim=(2, 4))
        y = dense_prelu(y.reshape(n, -1), dn["left"])
        # right branch: three conv + PReLU blocks, two pools (l3.b1)
        r = conv3x3_bn_act(x, act="prelu", pool=True, **right[0])
        r = conv3x3_bn_act(r, act="prelu", **right[1])
        r = conv3x3_bn_act(r, act="prelu", pool=True, **right[2])
        r = dense_prelu(r.reshape(n, -1), dn["right"])
        # head: Dense 256 + PReLU, Dense 1 + Sigmoid (l4-l8)
        y = dense_prelu(torch.cat([y, r], dim=-1), dn["l4"])
        l7 = dn["l7"]
        return torch.sigmoid(_dense_act(y, l7["k"], l7["b"], "none", dtype))

    return FastForward(prepare, run)
