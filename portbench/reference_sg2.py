"""The plain reference of StyleGAN2 config F's generator and of the
refinement of z through it, in plain PyTorch and float32 (TF32 off), from
the weights that :func:`make` draws from the seed.

It follows the equations of Karras et al., arXiv:1912.04958, as
NVlabs/stylegan2 writes them (``G_mapping``, ``G_synthesis_stylegan2``,
``modulated_conv2d_layer``, ``upfirdn_2d``): each modulated convolution
builds the per-sample weight w'' = d s w and runs it as a grouped
convolution, one group per image; the up-sampling convolution runs that
weight flipped as a stride-2 transposed convolution, then the FIR blur;
the skip image is up-sampled by zero insertion, padding and the FIR. The
program computes the same convolutions with the shared weight on scaled
activations, so the comparison holds two formulations against each other.
It imports nothing of the program. Activations are NCHW inside and NHWC at
the boundaries. The port's CPU tests (``tests/test_torch_port_sg2.py``)
hold the program to it too, at a tiny size.

Departures from the official network: the program computes in the
configuration's bfloat16 (operands rounded, f32 sums), this in float32;
the noise is the "const" mode (one fixed map a layer, drawn from the
seed); truncation 1 and no style mixing; z is refined with adam on each
image's pixel MSE, not the projector's LPIPS on w and the noise.

``prec`` rounds as ``reference.Precision`` does: the operands of every
dense layer and convolution (the per-sample weight included), each
layer's output, and the gradient at each product's output; ``FP8`` is the
control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .reference import F32, Precision, ieee_f32

EPS = 1e-8
SQRT2 = math.sqrt(2.0)


def config(raw: dict) -> dict:
    """The configuration file's sizes, as the functions here take them."""
    keys = ("noise_dim", "w_dim", "mapping_layers", "channel_base",
            "channel_max")
    return {"image": tuple(raw["image"]), "fir": tuple(raw["fir"]),
            "lr_mul": float(raw["lr_mul"]), **{k: int(raw[k]) for k in keys}}


def resolutions(cfg) -> list:
    return [2 ** i for i in range(2, int(math.log2(cfg["image"][1])) + 1)]


def channels(cfg, res: int) -> int:
    """min(fmap_base / 2^(log2(res) - 1), fmap_max)."""
    return min(2 * cfg["channel_base"] // res, cfg["channel_max"])


def leaves(cfg) -> list:
    """(name, shape, how it is drawn) of every weight, named as the
    program's ``create_G_sg2f`` names them."""
    zd, wd, img = cfg["noise_dim"], cfg["w_dim"], cfg["image"][0]
    out = []
    for i in range(1, cfg["mapping_layers"] + 1):
        out += [(f"mapping.l{i}.kernel", (zd if i == 1 else wd, wd), "lr"),
                (f"mapping.l{i}.bias", (wd,), "bias_lr")]

    def modconv(name, ci, co, k):
        return [(f"{name}.kernel", (k, k, ci, co), "normal"),
                (f"{name}.bias", (co,), "bias"),
                (f"{name}.affine.kernel", (wd, ci), "normal"),
                (f"{name}.affine.bias", (ci,), "one")]

    def layer(name, ci, co, res):
        return modconv(name, ci, co, 3) + [
            (f"{name}.noise", (res, res), "normal"),
            (f"{name}.strength", (), "strength")]

    prev = None
    for r in resolutions(cfg):
        c = channels(cfg, r)
        if prev is None:
            out += [("b4.const", (4, 4, c), "normal")]
            out += layer("b4.conv", c, c, 4)
        else:
            out += layer(f"b{r}.conv0", prev, c, r)
            out += layer(f"b{r}.conv1", c, c, r)
        out += modconv(f"b{r}.torgb", c, img, 1)
        prev = c
    return out


def make(cfg, gen: torch.Generator, device) -> dict:
    """{name: f32 tensor}, stored as the official code stores weights:
    kernels and the constant N(0, 1) (the mapping's N(0, 1) / lr_mul, used
    at lr_mul / sqrt(fan_in)), the styles' biases 1, the other biases
    uniform in [-0.1, 0.1] at their runtime scale, the noise maps N(0, 1)
    and their strengths uniform in [0.05, 0.2]; the normal leaves from one
    draw on ``device``, the uniform ones from another."""
    spec = leaves(cfg)
    sizes = {how: sum(math.prod(s) for _, s, h in spec if h in hows)
             for how, hows in (("normal", ("normal", "lr")),
                               ("uniform", ("bias", "bias_lr", "strength")))}
    draws = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, how in spec:
        if how == "one":
            out[name] = torch.ones(shape, device=device)
            continue
        kind = "normal" if how in ("normal", "lr") else "uniform"
        size = math.prod(shape)
        t = draws[kind][at[kind]:at[kind] + size].view(shape)
        at[kind] += size
        if kind == "uniform":
            lo, hi = (0.05, 0.2) if how == "strength" else (-0.1, 0.1)
            t = lo + (hi - lo) * t
        out[name] = t / cfg["lr_mul"] if how in ("lr", "bias_lr") else t
    return out


def lrelu(x):
    return F.leaky_relu(x, 0.2) * SQRT2


def dense(x, p, name, lr_mul: float = 1.0, prec: Precision = F32):
    """``dense_layer`` + its bias: the equalized learning rate's runtime
    weight and bias."""
    w = p[f"{name}.kernel"]
    w = w * (lr_mul / math.sqrt(w.shape[0]))
    return prec.out(prec.op(x) @ prec.op(w)) + p[f"{name}.bias"] * lr_mul


def fir_kernel(taps, gain: float, device) -> torch.Tensor:
    """``_setup_kernel``: the outer product, normalised to sum 1, times
    ``gain``."""
    f = torch.tensor(taps, dtype=torch.float32, device=device)
    k = torch.outer(f, f)
    return k / k.sum() * gain


def upfirdn2d(x, k, up: int, pad0: int, pad1: int):
    """``upfirdn_2d`` of NCHW ``x`` with down 1: ``up - 1`` zeros after
    each pixel, pad (pad0, pad1) on both axes, the convolution with ``k``
    (flipped, then correlated) of each channel."""
    n, c, h, w = x.shape
    x = x.reshape(n * c, 1, h, w)
    if up > 1:
        z = x.new_zeros(n * c, 1, h * up, w * up)
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    x = F.conv2d(x, k.flip(0, 1)[None, None])
    return x.reshape(n, c, x.shape[2], x.shape[3])


def modulated_conv(x, kernel, style, demodulate: bool = True,
                   up: bool = False, fir=(1, 3, 3, 1),
                   prec: Precision = F32):
    """``modulated_conv2d_layer`` with ``fused_modconv``: NCHW ``x``, the
    HWIO ``kernel`` at its runtime scale 1 / sqrt(Ci k k), ``style`` (N,
    Ci). The per-sample weight w' = s w, demodulated w'' = w' /
    sqrt(sum_{i,k} w'^2 + 1e-8), runs as a grouped convolution; ``up``:
    ``upsample_conv_2d``, the weight flipped as a stride-2 transposed
    convolution, then the FIR times 4 with pad (1, 1)."""
    n, ci, h, w = x.shape
    k, co = kernel.shape[0], kernel.shape[3]
    weight = kernel.permute(3, 2, 0, 1) / math.sqrt(ci * k * k)
    ww = weight[None] * style[:, None, :, None, None]        # N, Co, Ci, k, k
    if demodulate:
        ww = ww * torch.rsqrt((ww * ww).sum(dim=(2, 3, 4)) + EPS)[
            :, :, None, None, None]
    ww = prec.op(ww)
    x = prec.op(x).reshape(1, n * ci, h, w)
    if up:
        wt = ww.flip(3, 4).transpose(1, 2).reshape(n * ci, co, k, k)
        x = prec.out(F.conv_transpose2d(x, wt, stride=2, groups=n))
        x = upfirdn2d(prec.op(x), fir_kernel(fir, 4.0, x.device), 1, 1, 1)
    else:
        x = prec.out(F.conv2d(x, ww.reshape(n * co, ci, k, k),
                              padding=k // 2, groups=n))
    return x.reshape(n, co, x.shape[2], x.shape[3])


def _style(p, name, w, prec):
    return prec.act(dense(w, p, f"{name}.affine", prec=prec))


def layer(p, name, x, w, up=False, fir=(1, 3, 3, 1), prec: Precision = F32):
    """``layer()`` of the synthesis: the modulated convolution, + strength
    * noise, + bias, lrelu * sqrt(2)."""
    x = modulated_conv(x, p[f"{name}.kernel"], _style(p, name, w, prec),
                       up=up, fir=fir, prec=prec)
    x = x + p[f"{name}.noise"][None, None] * p[f"{name}.strength"]
    return prec.act(lrelu(x + p[f"{name}.bias"].view(1, -1, 1, 1)))


def torgb(p, name, x, w, prec: Precision = F32):
    x = modulated_conv(x, p[f"{name}.kernel"], _style(p, name, w, prec),
                       demodulate=False, prec=prec)
    return x + p[f"{name}.bias"].view(1, -1, 1, 1)


def generator(p, z, cfg, prec: Precision = F32):
    """z (N, noise_dim) -> NHWC images, float32, with TF32 off:
    ``G_mapping`` (pixel norm, the dense layers with lrelu), then the skip
    synthesis."""
    fir = cfg["fir"]
    with ieee_f32():
        z = z.float()
        x = prec.act(z * torch.rsqrt((z * z).mean(dim=1, keepdim=True) + EPS))
        for i in range(1, cfg["mapping_layers"] + 1):
            x = prec.act(lrelu(dense(x, p, f"mapping.l{i}", cfg["lr_mul"],
                                     prec)))
        w = x
        x = prec.act(p["b4.const"].permute(2, 0, 1)[None].expand(
            z.shape[0], -1, -1, -1))
        x = layer(p, "b4.conv", x, w, prec=prec)
        y = prec.act(torgb(p, "b4.torgb", x, w, prec))
        blur = fir_kernel(fir, 4.0, z.device)
        for r in resolutions(cfg)[1:]:
            x = layer(p, f"b{r}.conv0", x, w, up=True, fir=fir, prec=prec)
            x = layer(p, f"b{r}.conv1", x, w, prec=prec)
            y = prec.act(upfirdn2d(y, blur, 2, 2, 1)
                         + torgb(p, f"b{r}.torgb", x, w, prec))
    return y.permute(0, 2, 3, 1)


def refine(p, cfg, targets, z0, steps: int, lr: float, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-8, prec: Precision = F32,
           block: int | None = None):
    """adam on z through the generator, minimising each image's pixel MSE
    against the NHWC ``targets``, the bias correction folded into the step
    size as the program writes it. Rows are independent, so they are
    refined in blocks of ``block`` rows (all at once by default), which
    keeps the float32 activations of a 1024 x 1024 backward within the
    card. Returns (z, each image's loss at the last z)."""
    block = block or z0.shape[0]
    zs, losses = [], []
    for s in range(0, z0.shape[0], block):
        target = targets[s:s + block].float()
        z = z0[s:s + block].float().clone()
        m, v = torch.zeros_like(z), torch.zeros_like(z)

        def loss_of(zz):
            d = generator(p, zz, cfg, prec) - target
            return (d * d).mean(dim=(1, 2, 3))

        for t in range(1, steps + 1):
            z.requires_grad_(True)
            with torch.enable_grad(), ieee_f32():
                (g,) = torch.autograd.grad(loss_of(z).sum(), z)
            z = z.detach()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
            z = z - step * m / (torch.sqrt(v) + eps)
        with torch.no_grad():
            zs.append(z)
            losses.append(loss_of(z))
    return torch.cat(zs), torch.cat(losses)
