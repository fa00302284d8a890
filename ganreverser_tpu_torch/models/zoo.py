"""The model zoo — the counterparts of ganreverser_tpu/models/zoo.py: G3,
G4, G_encoder, D2, D_default, D_facegen, R (plain and fixer) and
createResidual, with the same layer indices — and StyleGAN2's config-F
generator (:func:`create_G_sg2f`, the port's own).

``dimensions`` is (C, H, W) as in the reference; tensors flow as NHWC. The
models are returned in evaluation mode (``.train()`` switches BatchNorm and
the dropouts to training); their weights are zero until loaded
(``models/bridge.py``, ``io/import_t7.py``) or drawn with
``modules.init_parameters``, each layer by the scheme ``init`` gave it.

``init`` is the JAX package's: ``heuristic`` (the default) applies the
scheme to every conv and dense layer with zero biases and ones as the
BatchNorm scales; ``xavier``, ``xavier_caffe`` and ``kaiming`` likewise;
``torch`` reproduces the reference's accidental initial distributions
(models/init.py of the JAX package has the accounting): w_init matches
modules by 'nn.*' typename and only at top level, so cudnn convs keep
torch's default reset, layers nested in sub-Sequentials or Concat branches
keep torch defaults with uniform biases, and BatchNorm scales are
uniform(0, 1). Each create_* says which layer gets what.
"""
from __future__ import annotations

import torch

from .modules import (Activation, AvgPool, BatchNorm, ConcatBranches, Conv,
                      Dense, Dropout, Flatten, Identity, MaxPool, PReLU,
                      Reshape, Residual, Sequential, SpatialDropout,
                      StyleGenerator, UpsampleConv, UpsampleNearest)

Dims = tuple  # (C, H, W)


def create_G(dimensions: Dims, noise_dim: int,
             dtype: torch.dtype = torch.float32, init: str = "heuristic"):
    """models.create_G == create_G3 (models.lua:201-203)."""
    return create_G3(dimensions, noise_dim, dtype, init)


def create_G3(dimensions: Dims, noise_dim: int,
              dtype: torch.dtype = torch.float32, init: str = "heuristic"):
    """create_G3 (models.lua:104-143): z -> Linear -> BN -> ReLU -> reshape
    H/4 x W/4 x 512 -> 2x [NN-upsample x2 + 3x3 conv + BN + ReLU] -> 3x3 conv
    -> Sigmoid. Each upsample+conv pair is one UpsampleConv after an
    Identity, the layer indices of the JAX package's fused G (its checkpoint
    keys are the same fused or not).

    ``init="torch"``: the convs are cudnn.SpatialConvolution upstream, so
    w_init never re-inits them: torch's default uniform(+-1/sqrt(9 Ci))
    weights with zeroed (top-level) biases; the Linear is heuristic; BN
    scales uniform(0, 1)."""
    c, h, w = dimensions
    sh, sw = h // 4, w // 4
    t = init == "torch"
    conv = dict(init_scheme="torch_default" if t else init)
    bn = dict(scale_init="torch" if t else "ones", dtype=dtype)
    return Sequential([
        Dense(noise_dim, 512 * sh * sw, dtype=dtype,
              init_scheme="heuristic" if t else init),
        BatchNorm(512 * sh * sw, **bn),
        Activation("relu"),
        Reshape((sh, sw, 512)),
        Identity(), UpsampleConv(512, 256, dtype=dtype, **conv),
        BatchNorm(256, **bn),
        Activation("relu"),
        Identity(), UpsampleConv(256, 128, dtype=dtype, **conv),
        BatchNorm(128, **bn),
        Activation("relu"),
        Conv(128, c, dtype=dtype, **conv),
        Activation("sigmoid"),
    ]).eval()


def create_G_sg2f(dimensions: Dims = (3, 1024, 1024), noise_dim: int = 512,
                  w_dim: int = 512, dtype: torch.dtype = torch.float32, *,
                  mapping_layers: int = 8, channel_base: int = 16384,
                  channel_max: int = 512):
    """StyleGAN2 config F (arXiv:1912.04958; NVlabs/stylegan2,
    ``run_training.py``'s config-f: ``fmap_base = 16 << 10``): a mapping of
    8 dense layers 512 -> 512, and the skip synthesis from a learned 4 x 4
    constant up to H x W, min(2 * 16384 / r, 512) channels at resolution r
    (512 up to 64 x 64, then 256, 128, 64, 32), with modulated and
    demodulated 3x3 convolutions, const noise inputs, ToRGB at every
    resolution and FIR up-sampling ([1, 3, 3, 1]). z (N, noise_dim) ->
    NHWC images. The keywords give smaller presets (the CPU tests)."""
    return StyleGenerator(dimensions, noise_dim, w_dim, dtype,
                          mapping_layers, channel_base, channel_max).eval()


def create_G4(dimensions: Dims, noise_dim: int,
              dtype: torch.dtype = torch.float32, init: str = "heuristic"):
    """create_G4 (models.lua:145-194, unused upstream): 32 parallel branches
    [Linear 16 -> PReLU -> Linear 16*16*16 -> BN -> PReLU -> reshape 16x16x16
    -> upsample -> conv16 -> BN -> PReLU], concatenated on channels to 512
    maps, then conv64 + BN + PReLU + conv-to-C + Sigmoid. Only 32x32
    outputs, as in the reference (models.lua:162-167).

    ``init="torch"``: every branch module is nested inside the nn.Concat,
    so w_init touches none of it (torch defaults with uniform biases); the
    two top-level cudnn convs keep default weights with zeroed biases; BN
    scales uniform(0, 1)."""
    c, h, w = dimensions
    if (h, w) != (32, 32):
        raise ValueError(f"create_G4 builds 32x32 outputs only, got {h}x{w}")
    t = init == "torch"
    nested = dict(init_scheme="torch_default" if t else init,
                  init_zero_bias=not t, dtype=dtype)
    bn = dict(scale_init="torch" if t else "ones", dtype=dtype)

    def branch():
        return Sequential([
            Dense(noise_dim, 16, **nested),
            PReLU(),
            Dense(16, 16 * 16 * 16, **nested),
            BatchNorm(16 * 16 * 16, **bn),
            PReLU(),
            Reshape((16, 16, 16)),
            UpsampleNearest(2),
            Conv(16, 16, **nested),
            BatchNorm(16, **bn),
            PReLU(),
        ])

    top = dict(init_scheme="torch_default" if t else init, dtype=dtype)
    return Sequential([
        ConcatBranches([branch() for _ in range(32)]),
        Conv(512, 64, **top),
        BatchNorm(64, **bn),
        PReLU(),
        Conv(64, c, **top),
        Activation("sigmoid"),
    ]).eval()


def create_G_encoder(dimensions: Dims, noise_dim: int,
                     dtype: torch.dtype = torch.float32,
                     init: str = "heuristic"):
    """create_G_encoder (models.lua:57-102), the encoder of pretrain_g's
    autoencoder: conv16 + BN + ReLU + avgpool, conv32 + BN + ReLU + pool,
    conv64 + BN + ReLU + pool, Dense 512 + BN + ReLU, Dense noise_dim +
    Tanh. Each pool floors, so Dense 512 takes 64 (H // 8) (W // 8)
    inputs.

    ``init="torch"``: cudnn convs keep torch-default weights (w_init
    typename miss) with zeroed biases; the Linears heuristic; BN
    uniform(0, 1)."""
    c, h, w = dimensions
    t = init == "torch"
    cs = "torch_default" if t else init
    ds = "heuristic" if t else init
    bn = dict(scale_init="torch" if t else "ones", dtype=dtype)

    def block(in_ch, feat, pool):
        return [Conv(in_ch, feat, dtype=dtype, init_scheme=cs),
                BatchNorm(feat, **bn), Activation("relu"), pool]

    return Sequential([
        *block(c, 16, AvgPool()),
        *block(16, 32, MaxPool()),
        *block(32, 64, MaxPool()),
        Flatten(),
        Dense(64 * (h // 8) * (w // 8), 512, dtype=dtype, init_scheme=ds),
        BatchNorm(512, **bn), Activation("relu"),
        Dense(512, noise_dim, dtype=dtype, init_scheme=ds),
        Activation("tanh"),
    ]).eval()


def create_D(dimensions: Dims, dtype: torch.dtype = torch.float32,
             init: str = "heuristic"):
    """models.create_D == create_D2 (models.lua:209-211)."""
    return create_D2(dimensions, dtype, init)


def _nxn(in_ch: int, features: int, kernel: int, dropout: float, dtype,
         init: str = "heuristic"):
    """create_D2's createNxN helper (models.lua:273-281): conv + PReLU, and
    a SpatialDropout when ``dropout`` > 0. Reference quirk kept: the
    argument only gates whether the dropout is added; its rate is always
    0.25.

    ``init="torch"``: these blocks are sub-Sequentials, so w_init never
    reaches the conv: weight and bias uniform(+-1/sqrt(k k Ci))."""
    t = init == "torch"
    layers = [Conv(in_ch, features, dtype=dtype, kernel=kernel,
                   init_scheme="torch_default" if t else init,
                   init_zero_bias=not t), PReLU()]
    if dropout > 0:
        layers.append(SpatialDropout(0.25))
    return Sequential(layers)


def create_D2(dimensions: Dims, dtype: torch.dtype = torch.float32,
              init: str = "heuristic"):
    """create_D2 (models.lua:272-337): a stem of two 3x3 conv + PReLU
    blocks and a pool, then two branches concatenated on features (left: a
    5x5 conv path; right: a deeper 3x3 path), each ending in Dense 512 +
    PReLU, then Dense 256 + PReLU + Dropout and Dense 1 + Sigmoid. H and W
    must be divisible by 8. Set the dropouts' generator
    (``modules.set_dropout_generator``) before a training forward.

    ``init="torch"``: only the two top-level Linears (1024->256, 256->1)
    are heuristic with zero bias; every conv (inside createNxN
    sub-Sequentials) and the two 512 branch Linears (inside the Concat)
    keep torch defaults with uniform biases."""
    c, h, w = dimensions
    if h % 8 or w % 8:
        raise ValueError(f"D2 needs H and W divisible by 8, got {h}x{w}")
    t = init == "torch"
    branch_dense = dict(init_scheme="torch_default" if t else init,
                        init_zero_bias=not t, dtype=dtype)
    top_dense = dict(init_scheme="heuristic" if t else init, dtype=dtype)
    left = Sequential([
        _nxn(128, 64, 5, 0.2, dtype, init),
        MaxPool(),
        Flatten(),
        Dense(64 * (h // 4) * (w // 4), 512, **branch_dense),
        PReLU(),
        Dropout(0.25),
    ])
    right = Sequential([
        _nxn(128, 128, 3, 0.2, dtype, init),
        MaxPool(),
        _nxn(128, 256, 3, 0.2, dtype, init),
        _nxn(256, 256, 3, 0.2, dtype, init),
        MaxPool(),
        Flatten(),
        Dense(256 * (h // 8) * (w // 8), 512, **branch_dense),
        PReLU(),
    ])
    return Sequential([
        _nxn(c, 128, 3, 0.0, dtype, init),
        _nxn(128, 128, 3, 0.2, dtype, init),
        MaxPool(),
        ConcatBranches([left, right]),
        Dense(1024, 256, **top_dense),
        PReLU(),
        Dropout(0.25),
        Dense(256, 1, **top_dense),
        Activation("sigmoid"),
    ]).eval()


def create_D_default(dimensions: Dims, dtype: torch.dtype = torch.float32,
                     init: str = "heuristic"):
    """create_D_default (models.lua:213-270, unused upstream): five conv +
    PReLU layers (32 to 512 maps; a SpatialDropout after the last four, an
    avgpool after the last three), Dense 512 + PReLU + Dropout, Dense 1 +
    Sigmoid. Every layer is a plain top-level nn module, so ``torch``
    draws as ``heuristic`` does."""
    c, h, w = dimensions
    if init == "torch":
        init = "heuristic"
    k = dict(init_scheme=init, dtype=dtype)
    return Sequential([
        Conv(c, 32, **k), PReLU(),
        Conv(32, 64, **k), PReLU(), SpatialDropout(0.25),
        Conv(64, 128, **k), PReLU(), SpatialDropout(0.25), AvgPool(),
        Conv(128, 256, **k), PReLU(), SpatialDropout(0.25), AvgPool(),
        Conv(256, 512, **k), PReLU(), SpatialDropout(0.25), AvgPool(),
        Flatten(),
        Dense(512 * (h // 8) * (w // 8), 512, **k), PReLU(), Dropout(0.5),
        Dense(512, 1, **k), Activation("sigmoid"),
    ]).eval()


def create_D_facegen(dimensions: Dims, dtype: torch.dtype = torch.float32,
                     init: str = "heuristic"):
    """create_D_facegen (models.lua:339-383, unused upstream): four conv +
    PReLU + SpatialDropout(0.2) + avgpool layers (64 to 512 maps), two
    Dense 512 + PReLU + Dropout, Dense 1 + Sigmoid. Plain top-level nn
    modules: ``torch`` draws as ``heuristic`` does."""
    c, h, w = dimensions
    if init == "torch":
        init = "heuristic"
    k = dict(init_scheme=init, dtype=dtype)
    return Sequential([
        Conv(c, 64, **k), PReLU(), SpatialDropout(0.2), AvgPool(),
        Conv(64, 128, **k), PReLU(), SpatialDropout(0.2), AvgPool(),
        Conv(128, 256, **k), PReLU(), SpatialDropout(0.2), AvgPool(),
        Conv(256, 512, **k), PReLU(), SpatialDropout(0.2), AvgPool(),
        Flatten(),
        Dense(512 * (h // 16) * (w // 16), 512, **k), PReLU(), Dropout(0.5),
        Dense(512, 512, **k), PReLU(), Dropout(0.5),
        Dense(512, 1, **k), Activation("sigmoid"),
    ]).eval()


def create_R(dimensions: Dims, noise_dim: int, noise_method: str,
             fixer: bool = False, dtype: torch.dtype = torch.float32,
             dropout_impl: str = "plain", init: str = "heuristic"):
    """models.create_R == create_R_default (models.lua:385-387)."""
    return create_R_default(dimensions, noise_dim, noise_method, fixer, dtype,
                            dropout_impl, init)


def create_R_default(dimensions: Dims, noise_dim: int, noise_method: str,
                     fixer: bool = False,
                     dtype: torch.dtype = torch.float32,
                     dropout_impl: str = "plain", init: str = "heuristic"):
    """create_R_default (models.lua:389-464): 3x [conv64 + BN + ELU] + pool,
    3x [conv128 + BN + ELU] + pool, Dense 512 + BN + ELU, Dense noise_dim,
    and a Tanh head only for uniform noise. ``fixer=True`` prepends the
    always-on Dropout(0.5) (models.lua:399-406), which shifts every layer
    index by one. The seven element dropouts and the fixer's take
    ``dropout_impl`` (``plain`` Bernoulli masks or ``kernel`` B5); the
    SpatialDropout always draws a plain mask. Set the dropouts' generator
    (``modules.set_dropout_generator``) before an active forward.

    ``init="torch"``: R is the one active model w_init fully reaches (plain
    nn layers, all top level), so its convs and Linears are heuristic with
    zero bias in both modes; only the BN scales are uniform(0, 1)."""
    if noise_method not in ("normal", "uniform"):
        raise ValueError(noise_method)
    c, h, w = dimensions
    sc = "heuristic" if init == "torch" else init
    bn = dict(scale_init="torch" if init == "torch" else "ones", dtype=dtype)

    def block(in_ch, feat):
        return [Conv(in_ch, feat, dtype=dtype, init_scheme=sc),
                BatchNorm(feat, **bn), Activation("elu")]

    def drop():  # nn.Dropout() default 0.5
        return Dropout(0.5, impl=dropout_impl)

    layers = [Dropout(0.5, always_on=True, impl=dropout_impl)] if fixer else []
    layers += [
        *block(c, 64), drop(),
        *block(64, 64), drop(),
        *block(64, 64), MaxPool(), drop(),
        *block(64, 128), drop(),
        *block(128, 128), drop(),
        *block(128, 128), SpatialDropout(0.25), MaxPool(),
        Flatten(),
        Dense(128 * (h // 4) * (w // 4), 512, dtype=dtype, init_scheme=sc),
        BatchNorm(512, **bn), Activation("elu"),
        drop(),
        Dense(512, noise_dim, dtype=dtype, init_scheme=sc),
    ]
    if noise_method != "normal":
        layers.append(Activation("tanh"))
    return Sequential(layers).eval()


def create_residual(nb_input: int, nb_inner: int, nb_output: int,
                    activation: str = "ReLU", bn: bool = True,
                    dtype: torch.dtype = torch.float32):
    """models.createResidual (models.lua:8-55, unused upstream): an inner
    path (a 1x1 conv to ``nb_inner`` when it differs from ``nb_input``, two
    3x3 convs, a 1x1 conv to ``nb_output`` when it differs, each with BN
    when ``bn`` and the activation) plus a shortcut (Identity when input
    and output widths match, else a 1x1 conv + BN + activation)."""
    act_name = {"ReLU": "relu", "PReLU": "prelu",
                "LeakyReLU": "leaky_relu"}.get(activation)
    if act_name is None:
        raise ValueError(f"Unknown activation {activation!r}")

    def unit(in_ch, out_ch, kernel):
        layers = [Conv(in_ch, out_ch, dtype=dtype, kernel=kernel)]
        if bn:
            layers.append(BatchNorm(out_ch, dtype=dtype))
        layers.append(PReLU() if act_name == "prelu"
                      else Activation(act_name))
        return layers

    inner = []
    width = nb_input
    if nb_input != nb_inner:
        inner += unit(nb_input, nb_inner, 1)
        width = nb_inner
    for _ in range(2):
        inner += unit(width, nb_inner, 3)
        width = nb_inner
    if nb_inner != nb_output:
        inner += unit(nb_inner, nb_output, 1)
    shortcut = (Identity() if nb_input == nb_output
                else Sequential(unit(nb_input, nb_output, 1)))
    return Residual(Sequential(inner), shortcut).eval()
