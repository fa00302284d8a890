"""Fast eval-mode G / R / D forwards through the hand-written kernels — the
counterparts of ganreverser_tpu/models/fastpath.py's ``make_fast_generator``
and ``make_fast_inverter``, and of D2's ``D.apply(v, x, train=False)``.

They consume the standard variable trees of create_G3 / create_R_default
(``{"params", "state"}``, here as tensors on the compute device; see
``models/bridge.to_torch``), fold each BatchNorm into a per-channel f32
scale/shift on every call, and run:

  G: z -> Dense(+BN folded)+ReLU                      [torch.matmul]
       -> upsample2+conv3x3+BN+ReLU (512->256)       [kernel U]
       -> upsample2+conv3x3+BN+ReLU (256->128)       [kernel U]
       -> conv3x3 (128->C) + Sigmoid                  [F.conv2d]

  R: images -> [conv64+BN+ELU x3 + pool]             [kernel B]
            -> [conv128+BN+ELU x3 + pool]            [kernel B]
            -> Dense(+BN folded)+ELU -> Dense (+Tanh for uniform)
                                                      [torch.matmul]

  D: images -> [conv3x3 + PReLU] x2 + pool          [kernel B6 x2]
            -> left:  conv5x5 + PReLU + pool          [F.conv2d]
               right: [conv3x3 + PReLU] + pool,
                      [conv3x3 + PReLU] x2 + pool     [kernel B6 x3]
            -> Dense + PReLU per branch, Dense + PReLU, Dense + Sigmoid
                                                      [torch.matmul]

as the JAX package leaves the dense layers, G's Co=C head and D's 5x5
conv to XLA outside any kernel. Their f32 precision is pinned by the
compute dtype (core/precision.py), not by the process-wide TF32 flags. On CUDA tensors
the kernels launch; on CPU tensors their plain versions run.

The fixer-R (``make_fast_fixer``) is R behind an always-on input dropout:
its mask is drawn outside the kernels, so the fixer runs on kernel B too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.conv_block_kernel import conv_block
from ..ops.conv_kernel import conv3x3_bn_act, fold_batchnorm
from ..ops.upsample_conv import conv_nhwc
from ..ops.upsample_conv_kernel import upsample2_conv3x3_bn_act
from .modules import apply_dropout, dense, dropout_keep_mask

Dims = tuple  # (C, H, W)

FIXER_DROPOUT = 0.5  # the fixer-R's input dropout rate (models.lua:399-406)


def make_fast_generator(dims: Dims, noise_dim: int,
                        dtype: torch.dtype = torch.bfloat16):
    """Returns ``generate(g_variables, z) -> images`` equal to
    ``create_G3(...)`` in evaluation on the same weights; images are NHWC
    in ``dtype``."""
    c, h, w = dims
    sh, sw = h // 4, w // 4

    def generate(variables, z):
        p, s = variables["params"], variables["state"]

        # Dense + folded BN + ReLU (models.lua:115-117)
        scale0, shift0 = fold_batchnorm(p["l1"], s["l1"], p["l0"]["bias"])
        k0 = p["l0"]["kernel"].float() * scale0[None, :]
        y = torch.clamp_min(dense(z, k0, dtype) + shift0, 0.0).to(dtype)
        x = y.reshape(z.shape[0], sh, sw, 512)

        # two fused upsample+conv+BN+ReLU stages (models.lua:121-130)
        for conv, bn in (("l5", "l6"), ("l9", "l10")):
            scale, shift = fold_batchnorm(p[bn], s[bn], p[conv]["bias"])
            x = upsample2_conv3x3_bn_act(x, p[conv]["kernel"].to(dtype),
                                         scale, shift, act="relu")

        # final 3x3 conv + sigmoid (models.lua:132-133)
        y = conv_nhwc(x, p["l12"]["kernel"], 1, dtype)
        return torch.sigmoid(y + p["l12"]["bias"]).to(dtype)

    return generate


def make_fast_inverter(dims: Dims, noise_dim: int, noise_method: str,
                       dtype: torch.dtype = torch.bfloat16):
    """Returns ``invert(r_variables, images) -> z_hat`` equal to the plain
    ``create_R_default(...)`` in evaluation on the same weights; z_hat is in
    ``dtype``."""
    if noise_method not in ("normal", "uniform"):
        raise ValueError(noise_method)

    def invert(variables, images):
        p, s = variables["params"], variables["state"]

        def block(x, layers):
            kernels, scales, shifts = [], [], []
            for conv, bn in layers:
                sc, sh_ = fold_batchnorm(p[bn], s[bn], p[conv]["bias"])
                kernels.append(p[conv]["kernel"].to(dtype))
                scales.append(sc)
                shifts.append(sh_)
            return conv_block(x, kernels, scales, shifts, act="elu",
                              pool=True)

        # two blocks of 3x [conv + BN + ELU] + maxpool2 (models.lua:409-440)
        x = block(images.to(dtype).contiguous(),
                  (("l0", "l1"), ("l4", "l5"), ("l8", "l9")))
        x = block(x, (("l13", "l14"), ("l17", "l18"), ("l21", "l22")))

        # head: Dense(+BN folded)+ELU -> Dense (models.lua:446-451)
        x = x.reshape(x.shape[0], -1)
        scd, shd = fold_batchnorm(p["l28"], s["l28"], p["l27"]["bias"])
        kd = p["l27"]["kernel"].float() * scd[None, :]
        y = F.elu(dense(x, kd, dtype) + shd).to(dtype)
        z = dense(y, p["l31"]["kernel"], dtype) + p["l31"]["bias"]
        if noise_method != "normal":
            z = torch.tanh(z)  # models.lua:452-454
        return z.to(dtype)

    return invert


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
    as the reference's nn.Dropout does on every forward."""
    invert = make_fast_inverter(dims, noise_dim, noise_method, dtype)

    def invert_fixer(variables, images, generator):
        keep = dropout_keep_mask(images.shape, FIXER_DROPOUT, generator,
                                 images.device)
        return invert(_unshift_layers(variables),
                      apply_dropout(images, keep, FIXER_DROPOUT))

    return invert_fixer


def make_fast_discriminator(dims: Dims, dtype: torch.dtype = torch.bfloat16):
    """Returns ``rate(d_variables, images) -> (N, 1)`` probabilities in
    ``dtype``, D2 in evaluation (``create_D2(...)`` under ``.eval()``, the
    dropouts the identity) on the same weights. Five of D2's six
    convolutions run on kernel B6 with scale 1, shift = the conv bias and
    the PReLU slope read from its (1,) parameter on the device; the pool
    that follows three of them is fused. The 5x5 conv of the left branch
    and the dense layers keep the module path's arithmetic: f32 sums of
    ``dtype``-rounded operands, the bias added in f32, one rounding, then
    PReLU in ``dtype``."""
    c, h, w = dims
    if h % 8 or w % 8:
        raise ValueError(f"D2 needs H and W divisible by 8, got {h}x{w}")

    def prelu(x, alpha):
        return torch.where(x >= 0, x, alpha.to(x.dtype) * x)

    def b6(x, nxn, pool):
        """create_D2's conv + PReLU block ``nxn`` (its l0, l1) on B6."""
        k = nxn["l0"]["kernel"]
        ones = torch.ones(k.shape[-1], device=x.device)
        return conv3x3_bn_act(x, k.to(dtype), ones, nxn["l0"]["bias"],
                              act="prelu", prelu_alpha=nxn["l1"]["alpha"],
                              pool=pool)

    def dense_prelu(x, lin, act):
        y = (dense(x, lin["kernel"], dtype) + lin["bias"]).to(dtype)
        return prelu(y, act["alpha"])

    def rate(variables, images):
        p = variables["params"]
        left, right = p["l3"]["b0"], p["l3"]["b1"]
        # stem: two conv + PReLU blocks, the second with the pool (l0-l2)
        x = b6(images.to(dtype).contiguous(), p["l0"], False)
        x = b6(x, p["l1"], True)
        n = x.shape[0]
        # left branch: 5x5 conv + PReLU + pool, Dense + PReLU (l3.b0)
        y = (conv_nhwc(x, left["l0"]["l0"]["kernel"], 2, dtype)
             + left["l0"]["l0"]["bias"]).to(dtype)
        y = prelu(y, left["l0"]["l1"]["alpha"])
        y = y.reshape(n, h // 4, 2, w // 4, 2, -1).amax(dim=(2, 4))
        y = dense_prelu(y.reshape(n, -1), left["l3"], left["l4"])
        # right branch: three conv + PReLU blocks, two pools (l3.b1)
        r = b6(x, right["l0"], True)
        r = b6(r, right["l2"], False)
        r = b6(r, right["l3"], True)
        r = dense_prelu(r.reshape(n, -1), right["l6"], right["l7"])
        # head: Dense 256 + PReLU, Dense 1 + Sigmoid (l4-l8)
        y = dense_prelu(torch.cat([y, r], dim=-1), p["l4"], p["l5"])
        y = (dense(y, p["l7"]["kernel"], dtype) + p["l7"]["bias"]).to(dtype)
        return torch.sigmoid(y)

    return rate
