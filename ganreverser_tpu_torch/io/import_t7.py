"""Map Torch7 checkpoints (the reference's ``*.net`` files) into this
framework's checkpoints — the port's counterpart of
ganreverser_tpu/io/import_t7.py, walking the port's ``nn.Module``s.

The reference saves (all via ``torch.save``):
  * train.lua:256        {D, G, opt, plot_data, epoch, vis_noise_inputs,
                          normalize_mean, normalize_std}
  * train_r.lua:234      {R, opt}
  * pretrain_with_previous_net.lua:265  {G, D, opt}
  * pretrain_g.lua:202   {G = decoder-only, opt, EPOCH}

``import_t7`` reads one such file (io/torch7.py), rebuilds the matching
zoo model(s) from the embedded ``opt`` (for R files train_r.lua:71-75
copies noiseDim/noiseMethod/height/width/colorSpace from the G checkpoint
into OPT before the save at :234, and ``fixer`` is a saved lapp flag —
module-shape inference is only the fallback for hand-stripped opts),
walks the serialized ``nn`` graph alongside the module tree, and converts
every parameter:

  nn.Linear                     weight (out,in)        -> kernel (in,out)
  [cudnn|nn].SpatialConvolution weight (out,in,kh,kw)  -> kernel HWIO
  nn.[Spatial]BatchNormalization weight/bias/running_* -> scale/bias +
                                                          state mean/var
  nn.PReLU                      weight                 -> alpha

plus the NCHW->NHWC flatten-order fixups: torch's ``nn.View`` reshapes a
Linear's output as (C,H,W) and flattens conv maps C-major, while this
framework reshapes/flattens NHWC — so a Linear feeding a Reshape has its
output units permuted (and any BatchNorm between them likewise), and a
Linear following a Flatten has its input axis permuted.

The mapped ``{"params", "state"}`` trees are the JAX package's; they are
loaded into the port's modules (``models/bridge.py``) and written with fresh optimizer state from the
port's optimizers (``cli/common.py::ts_to_tree``): the reference's save
carries none (train.lua:256; its own resume restarts OPTSTATE fresh,
train.lua:110-125). For the same bytes the checkpoint equals the JAX
importer's leaf for leaf, in config and in extra, except
``vis_noise_inputs`` when the file has none: the port draws them from the
visualisation stage of ``--seed`` (``core/prng.py``), not from
``jax.random``.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.config import GanConfig, RConfig
from ..core.prng import PREVIEW_STAGE, noise_inputs, stage_generator
from ..models import bridge, zoo
from ..models import modules as mm
from ..optim import adam
from ..train.state import GanState, TrainState
from . import checkpoint as gio
from . import torch7
from .torch7 import TorchObject, table_to_list

# torch modules that hold no trainable parameters — skipped when pairing
# the serialized graph with the module tree
_SKIP_TORCH = {
    "nn.Copy", "nn.View", "nn.Reshape", "nn.Identity",
    "nn.Dropout", "nn.SpatialDropout",
    "nn.ReLU", "cudnn.ReLU", "nn.ELU", "cudnn.ELU", "nn.LeakyReLU",
    "nn.Sigmoid", "cudnn.Sigmoid", "nn.Tanh", "cudnn.Tanh",
    "nn.SpatialUpSamplingNearest",
    "nn.SpatialMaxPooling", "cudnn.SpatialMaxPooling",
    "nn.SpatialAveragePooling", "cudnn.SpatialAveragePooling",
    "nn.CAddTable", "nn.JoinTable", "nn.Flatten",
}
_CONV_TORCH = {"nn.SpatialConvolution", "cudnn.SpatialConvolution",
               "nn.SpatialConvolutionMM"}
_BN_TORCH = {"nn.BatchNormalization", "nn.SpatialBatchNormalization",
             "cudnn.SpatialBatchNormalization", "cudnn.BatchNormalization"}


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


class ImportError7(ValueError):
    """A structural mismatch between the t7 graph and the zoo model."""


def _map_linear(tm: TorchObject, in_hwc: Optional[tuple],
                out_hwc: Optional[tuple]) -> dict:
    w = _f32(tm["weight"])                    # (out, in)
    b = _f32(tm["bias"])
    out_n, in_n = w.shape
    if in_hwc is not None:                    # Flatten fed this Linear
        h, wd, c = in_hwc
        if c * h * wd != in_n:
            raise ImportError7(f"Linear in={in_n} != flattened {in_hwc}")
        w = w.reshape(out_n, c, h, wd).transpose(0, 2, 3, 1).reshape(out_n,
                                                                     in_n)
    if out_hwc is not None:                   # a Reshape consumes the output
        h, wd, c = out_hwc
        if c * h * wd != out_n:
            raise ImportError7(f"Linear out={out_n} != reshape {out_hwc}")
        w = w.reshape(c, h, wd, in_n).transpose(1, 2, 0, 3).reshape(out_n,
                                                                    in_n)
        b = b.reshape(c, h, wd).transpose(1, 2, 0).reshape(-1)
    return {"kernel": w.T.copy(), "bias": b}


def _map_conv(tm: TorchObject) -> dict:
    w = _f32(tm["weight"])
    if w.ndim == 2:  # SpatialConvolutionMM stores (out, in*kh*kw)
        w = w.reshape(int(tm["nOutputPlane"]), int(tm["nInputPlane"]),
                      int(tm["kH"]), int(tm["kW"]))
    if w.ndim != 4:
        raise ImportError7(f"conv weight ndim {w.ndim}")
    return {"kernel": w.transpose(2, 3, 1, 0).copy(),  # OIHW -> HWIO
            "bias": _f32(tm["bias"])}


def _perm_vec_chw_to_hwc(v: np.ndarray, hwc: tuple) -> np.ndarray:
    h, w, c = hwc
    return v.reshape(c, h, w).transpose(1, 2, 0).reshape(-1)


def _map_batchnorm(tm: TorchObject, out_hwc: Optional[tuple]) -> tuple:
    scale = _f32(tm["weight"])
    bias = _f32(tm["bias"])
    mean = _f32(tm["running_mean"])
    if "running_var" in tm:
        var = _f32(tm["running_var"])
    else:
        # pre-2015 nn kept running_std = 1/sqrt(var+eps)
        eps = float(tm.get("eps", 1e-5))
        var = 1.0 / np.square(_f32(tm["running_std"])) - eps
    if out_hwc is not None:  # 1D BN inside a Linear->View window (G3/G4)
        scale, bias, mean, var = (
            _perm_vec_chw_to_hwc(v, out_hwc) for v in (scale, bias, mean,
                                                       var))
    return ({"scale": scale, "bias": bias}, {"mean": mean, "var": var})


# ---------------------------------------------------------------------------
# tree walk
# ---------------------------------------------------------------------------

def out_shape(module: torch.nn.Module, in_shape: tuple) -> tuple:
    """The per-sample output shape (NHWC, no batch axis) of a zoo module
    for the per-sample ``in_shape`` (the JAX modules' ``out_shape``)."""
    if isinstance(module, mm.Dense):
        return tuple(in_shape[:-1]) + (module.kernel.shape[1],)
    if isinstance(module, mm.UpsampleConv):
        h, w, _ = in_shape
        return (2 * h, 2 * w, module.kernel.shape[-1])
    if isinstance(module, mm.Conv):
        return tuple(in_shape[:-1]) + (module.kernel.shape[-1],)
    if isinstance(module, (mm.MaxPool, mm.AvgPool)):
        h, w, c = in_shape
        return (h // 2, w // 2, c)
    if isinstance(module, mm.UpsampleNearest):
        h, w, c = in_shape
        return (h * module.scale, w * module.scale, c)
    if isinstance(module, mm.Flatten):
        return (int(np.prod(in_shape)),)
    if isinstance(module, mm.Reshape):
        return tuple(module.shape)
    if isinstance(module, mm.Sequential):
        for m in module.children():
            in_shape = out_shape(m, in_shape)
        return tuple(in_shape)
    if isinstance(module, mm.ConcatBranches):
        shapes = [out_shape(b, in_shape) for b in module.children()]
        return shapes[0][:-1] + (sum(s[-1] for s in shapes),)
    if isinstance(module, mm.Residual):
        return out_shape(module.inner, in_shape)
    return tuple(in_shape)  # elementwise layers keep the shape


class _Cursor:
    """Pairs the param-bearing layers with the serialized module list,
    skipping torch's parameter-free layers in order."""

    def __init__(self, torch_mods: Sequence[TorchObject], where: str):
        self.mods = list(torch_mods)
        self.i = 0
        self.where = where

    def next(self, expected: set[str]) -> TorchObject:
        while self.i < len(self.mods):
            m = self.mods[self.i]
            self.i += 1
            cls = m.torch_class if isinstance(m, TorchObject) else type(m)
            if cls in expected:
                return m
            if cls in _SKIP_TORCH:
                continue
            raise ImportError7(
                f"{self.where}: serialized {cls} where one of "
                f"{sorted(expected)} was expected")
        raise ImportError7(f"{self.where}: ran out of serialized modules "
                           f"(wanted one of {sorted(expected)})")

    def finish(self):
        for m in self.mods[self.i:]:
            cls = m.torch_class if isinstance(m, TorchObject) else type(m)
            if cls not in _SKIP_TORCH:
                raise ImportError7(
                    f"{self.where}: unconsumed serialized module {cls}")


def map_module(module: torch.nn.Module, torch_mod: TorchObject,
               in_shape: tuple, where: str = "root") -> dict:
    """Recursively map one zoo module's parameters/state out of its
    serialized torch counterpart. Returns ``{"params":…, "state":…}`` of
    numpy arrays, the JAX package's variable tree for that module."""

    if isinstance(module, mm.Sequential):
        if torch_mod.torch_class != "nn.Sequential":
            raise ImportError7(f"{where}: {torch_mod.torch_class} for "
                               "Sequential")
        return _map_sequential(module, torch_mod, in_shape, where)
    if isinstance(module, mm.ConcatBranches):
        if torch_mod.torch_class not in ("nn.Concat", "nn.DepthConcat"):
            raise ImportError7(f"{where}: {torch_mod.torch_class} for "
                               "ConcatBranches")
        branches = list(module.children())
        tms = table_to_list(torch_mod.get("modules"))
        if len(tms) != len(branches):
            raise ImportError7(f"{where}: {len(tms)} serialized branches "
                               f"vs {len(branches)}")
        params, state = {}, {}
        for i, (b, tm) in enumerate(zip(branches, tms)):
            v = map_module(b, tm, in_shape, f"{where}.b{i}")
            if v["params"]:
                params[f"b{i}"] = v["params"]
            if v["state"]:
                state[f"b{i}"] = v["state"]
        return {"params": params, "state": state}
    if isinstance(module, mm.Residual):
        # createResidual serializes as Sequential[ConcatTable[inner,
        # shortcut], CAddTable] (models.lua:42-54)
        mods = table_to_list(torch_mod.get("modules"))
        conc = next((m for m in mods
                     if isinstance(m, TorchObject)
                     and m.torch_class == "nn.ConcatTable"), None)
        if conc is None:
            raise ImportError7(f"{where}: no ConcatTable in residual")
        inner_t, short_t = table_to_list(conc.get("modules"))
        vi = map_module(module.inner, inner_t, in_shape, f"{where}.inner")
        if (isinstance(module.shortcut, mm.Identity)
                or not isinstance(short_t, TorchObject)
                or short_t.torch_class == "nn.Identity"):
            vs = {"params": {}, "state": {}}
        else:
            vs = map_module(module.shortcut, short_t, in_shape,
                            f"{where}.shortcut")
        return {"params": {"inner": vi["params"],
                           "shortcut": vs["params"]},
                "state": {"inner": vi["state"],
                          "shortcut": vs["state"]}}
    raise ImportError7(f"{where}: cannot map container "
                       f"{type(module).__name__}")


def _lookahead_reshape(layers, start: int):
    """The Reshape target consuming a Dense's output, if the only layers
    between them are parameter-free or BatchNorm (the G3/G4 Linear->BN->
    act->View window, models.lua:115-118/160-166)."""
    for m in layers[start:]:
        if isinstance(m, mm.Reshape):
            return tuple(m.shape)
        if isinstance(m, (mm.BatchNorm, mm.Activation, mm.Dropout,
                          mm.PReLU, mm.Identity)):
            continue
        return None
    return None


def _map_sequential(seq, torch_mod: TorchObject, in_shape: tuple,
                    where: str) -> dict:

    cur = _Cursor(table_to_list(torch_mod.get("modules")), where)
    layers = list(seq.children())
    params: dict = {}
    state: dict = {}
    shape = tuple(in_shape)
    pending_in: Optional[tuple] = None   # set by Flatten over (h,w,c)
    pending_out: Optional[tuple] = None  # set by Dense feeding a Reshape

    for i, m in enumerate(layers):
        key = f"l{i}"
        if isinstance(m, mm.Flatten):
            pending_in = shape if len(shape) == 3 else None
        elif isinstance(m, mm.Reshape):
            pending_out = None
        elif isinstance(m, mm.Dense):
            tm = cur.next({"nn.Linear"})
            out_hwc = _lookahead_reshape(layers, i + 1)
            params[key] = _map_linear(tm, pending_in, out_hwc)
            pending_in = None
            pending_out = out_hwc
        elif isinstance(m, mm.Conv):  # UpsampleConv too
            tm = cur.next(_CONV_TORCH)
            params[key] = _map_conv(tm)
        elif isinstance(m, mm.BatchNorm):
            tm = cur.next(_BN_TORCH)
            p, s = _map_batchnorm(tm, pending_out)
            params[key], state[key] = p, s
        elif isinstance(m, mm.PReLU):
            tm = cur.next({"nn.PReLU"})
            params[key] = {"alpha": _f32(tm["weight"]).reshape(-1)}
        elif isinstance(m, (mm.Sequential, mm.ConcatBranches, mm.Residual)):
            expected = ({"nn.Concat", "nn.DepthConcat"}
                        if isinstance(m, mm.ConcatBranches)
                        else {"nn.Sequential"})
            tm = cur.next(expected)
            v = map_module(m, tm, shape, f"{where}.{key}")
            if v["params"]:
                params[key] = v["params"]
            if v["state"]:
                state[key] = v["state"]
        # parameter-free layers (Activation/Dropout/pools/Upsample/Identity)
        # consume nothing from the serialized stream
        shape = out_shape(m, shape)

    cur.finish()
    return {"params": params, "state": state}


# ---------------------------------------------------------------------------
# checkpoint-level import
# ---------------------------------------------------------------------------

def _opt_to_dict(opt) -> dict:
    if opt is None:
        return {}
    d = opt.payload if isinstance(opt, TorchObject) else dict(opt)
    out = {}
    for k, v in d.items():
        if isinstance(k, str):
            # lapp's --continue is our --cont (Python keyword)
            out["cont" if k == "continue" else k] = v
    # lapp stores gpu=false once train.lua:53 normalizes it; drop non-config
    for dead in ("gpu", "threads", "window", "aws", "nopretraining"):
        out.pop(dead, None)
    return out


def _scalarize(x):
    if isinstance(x, np.ndarray):
        return x.reshape(-1).tolist() if x.size > 1 else float(x.reshape(())[()])
    return x


def _infer_r_geometry(r_mod: TorchObject, known: Optional[dict] = None) -> dict:
    """Geometry of a serialized R. The saved opt is authoritative where
    present — train_r.lua:71-75 copies noiseDim/noiseMethod/height/width
    (and colorSpace) from the G checkpoint into OPT before the save at
    train_r.lua:234, and ``fixer`` is a saved lapp flag (train_r.lua:28) —
    so callers pass those as ``known`` and only the gaps are read off the
    modules: C from the first conv, H*W from the head Linear fan-in, fixer
    from a leading always-on Dropout, uniform from a Tanh tail
    (models.lua:389-464).

    GPU-trained files (the default: train_r.lua gpu=0 -> cuda=true) wrap
    the net in nn.Copy at both ends (models.lua:393-395, 458-459;
    prepareNetworkForSave never strips them) — those wrappers are dropped
    before looking at the first/last modules, otherwise fixer/uniform
    would silently misdetect as False/normal."""
    known = {k: v for k, v in (known or {}).items() if v is not None}
    mods = table_to_list(r_mod.get("modules"))

    def _cls(m):
        return m.torch_class if isinstance(m, TorchObject) else ""

    core = [m for m in mods if _cls(m) != "nn.Copy"]
    first_conv = next(m for m in core if _cls(m) in _CONV_TORCH)
    c = int(first_conv["nInputPlane"])
    linears = [m for m in core if _cls(m) == "nn.Linear"]
    head, last = linears[0], linears[-1]
    nd_file = int(last["weight"].shape[0])
    if "noiseDim" in known and int(known["noiseDim"]) != nd_file:
        raise ImportError7(
            f"saved opt.noiseDim={int(known['noiseDim'])} but the file's "
            f"output Linear has {nd_file} units — corrupt checkpoint?")
    geo = {"channels": c, "noiseDim": nd_file,
           "noiseMethod": ("uniform" if _cls(core[-1]) in
                           ("nn.Tanh", "cudnn.Tanh") else "normal"),
           "fixer": _cls(core[0]) == "nn.Dropout"}
    for k in ("noiseMethod", "fixer"):
        if k in known:
            geo[k] = known[k]
    hw = (int(head["weight"].shape[1]) // 128) * 16  # 128 maps at (H/4, W/4)
    if "height" in known and "width" in known:
        geo["height"], geo["width"] = int(known["height"]), int(known["width"])
    elif "height" in known:
        geo["height"] = int(known["height"])
        geo["width"] = hw // geo["height"]
    elif "width" in known:
        geo["width"] = int(known["width"])
        geo["height"] = hw // geo["width"]
    else:
        side = int(round(hw ** 0.5))
        if side * side != hw:
            raise ImportError7(
                f"cannot infer a square geometry from head fan-in "
                f"{head['weight'].shape[1]} — pass --height/--width")
        geo["height"] = geo["width"] = side
    return geo


def import_t7(path: str, out_dir: str, *, height: Optional[int] = None,
              width: Optional[int] = None, verbose: bool = True) -> str:
    """Convert one reference checkpoint file to a framework checkpoint
    directory under ``out_dir``. Returns the written checkpoint path."""
    from ..cli.common import gan_optimizers, gan_to_tree, ts_to_tree

    top = torch7.load(path)
    if not isinstance(top, dict):
        raise ImportError7(f"{path}: top-level object is "
                           f"{type(top).__name__}, expected a table")
    cfgd = _opt_to_dict(top.get("opt"))
    log = print if verbose else (lambda *a, **k: None)

    if "R" in top:  # train_r.lua:234 {R, opt}
        known = {k: cfgd.get(k) for k in ("height", "width", "noiseDim",
                                          "noiseMethod", "fixer")}
        if height:
            known["height"] = height
        if width:
            known["width"] = width
        geo = _infer_r_geometry(top["R"], known)
        cfg = RConfig.from_dict({**cfgd, **{
            k: geo[k] for k in ("height", "width", "noiseDim",
                                "noiseMethod", "fixer")}})
        if "colorSpace" not in cfgd:
            cfg.colorSpace = {1: "y", 3: cfg.colorSpace}.get(
                geo["channels"], cfg.colorSpace)
        dims = (geo["channels"], cfg.height, cfg.width)
        R = zoo.create_R(dims, cfg.noiseDim, cfg.noiseMethod, fixer=cfg.fixer)
        rv = map_module(R, top["R"], (cfg.height, cfg.width,
                                      geo["channels"]), "R")
        ts = TrainState.create(bridge.load_jax_variables(R, rv), adam())
        ckpt = gio.r_name(out_dir, dims[0], cfg.height, cfg.width,
                          cfg.noiseDim, cfg.noiseMethod, cfg.fixer)
        gio.save_checkpoint(ckpt, {"R": ts_to_tree(ts)},
                            config=cfg.to_dict(), extra={"batch": 0})
        log(f"[import_t7] R ({'fixer, ' if cfg.fixer else ''}"
            f"{dims[0]}x{cfg.height}x{cfg.width}, noiseDim="
            f"{cfg.noiseDim} {cfg.noiseMethod}) -> {ckpt}")
        return ckpt

    if "G" not in top:
        raise ImportError7(
            f"{path}: no G/R key — found {sorted(k for k in top if isinstance(k, str))}")

    cfg = GanConfig.from_dict(cfgd)
    if height:
        cfg.height = height
    if width:
        cfg.width = width
    dims = cfg.img_dims()
    c, h, w = dims

    G = zoo.create_G(dims, cfg.noiseDim)
    bridge.load_jax_variables(G, map_module(G, top["G"], (cfg.noiseDim,),
                                            "G"))

    if "D" not in top:  # pretrain_g.lua:202 decoder-only {G, opt, EPOCH}
        ckpt = gio.g_pretrained_name(out_dir, c, h, w, cfg.noiseDim)
        gio.save_checkpoint(ckpt, bridge.export_variables(G),
                            config=cfg.to_dict(),
                            extra={"epoch": int(top.get("EPOCH", 0))})
        log(f"[import_t7] pretrained G decoder ({c}x{h}x{w}, noiseDim="
            f"{cfg.noiseDim}) -> {ckpt}")
        return ckpt

    D = zoo.create_D(dims)
    bridge.load_jax_variables(D, map_module(D, top["D"], (h, w, c), "D"))
    g_opt, d_opt = gan_optimizers(cfg)
    gs = GanState(g=TrainState.create(G, g_opt), d=TrainState.create(D, d_opt))

    vis = top.get("vis_noise_inputs")
    if vis is None:
        vis = noise_inputs(stage_generator(cfg.seed, PREVIEW_STAGE, "cpu"),
                           100, cfg.noiseDim, cfg.noiseMethod)
    tree = gan_to_tree(gs, {"vis_noise_inputs": vis})
    extra = {"epoch": int(top.get("epoch", 0)),
             "plot_data": [[float(x) for x in table_to_list(row)]
                           for row in table_to_list(top.get("plot_data"))]}
    for k in ("normalize_mean", "normalize_std"):
        if top.get(k) is not None:
            extra[k] = _scalarize(top[k])

    name = os.path.basename(path)
    is_adversarial = "epoch" in top or "vis_noise_inputs" in top
    ckpt = (gio.adversarial_name(out_dir) if is_adversarial
            else gio.pretrained_name(out_dir, c, h, w, cfg.noiseDim))
    gio.save_checkpoint(ckpt, tree, config=cfg.to_dict(), extra=extra)
    log(f"[import_t7] G+D ({name}: {c}x{h}x{w}, noiseDim={cfg.noiseDim}, "
        f"epoch={extra['epoch']}) -> {ckpt}")
    return ckpt
