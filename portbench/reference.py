"""The plain reference: G3, R_default and D2 of models.lua, the cosine
search, the refinement's adam and the adversarial G/D step, in plain PyTorch
and float32, from the weights that ``weights.py`` makes.

It imports nothing of the program and takes nothing the program made: the
weights are the benchmark's own trees, BatchNorm is applied as written
(running statistics in evaluation, the batch's in training), and D's dropout
masks are drawn here from a generator seeded as the program's, in the
program's order of layers. Activations are NCHW inside and NHWC at the
boundaries, as the program's are; flattening is in (H, W, C) order.

``Precision`` rounds what a computation in a lower type would hold in it:
the operands of every convolution and dense layer, every layer's output
(as the program holds each layer's output in its compute type) and the
gradient arriving at each convolution and dense output. ``F32`` rounds
nothing; ``FP8`` rounds each to float8 e4m3 with one scale per tensor, the
control that computes in the precision below the configurations'
bfloat16.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BCE_EPS = 1e-7
CALIBRATION = 256  # latents whose statistics calibrate_batchnorm takes
R_BLOCKS = ((("l0", "l1"), ("l4", "l5"), ("l8", "l9")),
            (("l13", "l14"), ("l17", "l18"), ("l21", "l22")))


@contextlib.contextmanager
def ieee_f32():
    """IEEE float32 convolutions and products (no TF32) inside the block."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at e4m3's largest finite value 448), held in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class Precision:
    """Rounding of the operands (``op``) and outputs (``act``) of a layer,
    and of the gradient at each convolution and dense output (``out``)."""

    def __init__(self, rounded: bool):
        self.rounded = rounded

    def op(self, x):
        """``x`` rounded, the gradient passed through as it is."""
        return x + (fp8_round(x) - x).detach() if self.rounded else x

    act = op

    def out(self, y):
        return _RoundGrad.apply(y) if self.rounded and y.requires_grad else y


F32 = Precision(False)
FP8 = Precision(True)


def conv(x, kernel, bias, prec: Precision = F32):
    """k x k convolution, stride 1, SAME padding; ``x`` NCHW, ``kernel``
    HWIO."""
    w = kernel.permute(3, 2, 0, 1)
    y = prec.out(F.conv2d(prec.op(x), prec.op(w),
                          padding=(kernel.shape[0] - 1) // 2))
    return prec.act(y + bias.view(1, -1, 1, 1))


def dense(x, kernel, bias, prec: Precision = F32):
    return prec.act(prec.out(prec.op(x) @ prec.op(kernel)) + bias)


def batchnorm(x, p, name, mode: str, prec: Precision = F32):
    """BatchNorm over the channel axis (1), eps 1e-5: the running statistics
    in ``eval``, the batch mean and biased variance in ``train``; in
    ``calibrate`` the batch's, which also become the running statistics."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if mode != "eval":
        red = tuple(i for i in range(x.ndim) if i != 1)
        mean = x.mean(dim=red)
        var = x.var(dim=red, correction=0)
        if mode == "calibrate":
            p[f"{name}.mean"].copy_(mean)
            p[f"{name}.var"].copy_(var)
    else:
        mean, var = p[f"{name}.mean"], p[f"{name}.var"]
    inv = torch.rsqrt(var + BN_EPS) * p[f"{name}.scale"]
    return prec.act((x - mean.view(shape)) * inv.view(shape)
                    + p[f"{name}.bias"].view(shape))


def nhwc_flat(x):
    """NCHW -> (N, H * W * C) in (H, W, C) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def g3(p, z, image, mode: str = "eval", prec: Precision = F32):
    """G3 (models.lua:104-143): z -> NHWC images in [0, 1]; ``mode`` is
    BatchNorm's (:func:`batchnorm`)."""
    c, h, w = image
    x = torch.relu(batchnorm(dense(z, p["l0.kernel"], p["l0.bias"], prec), p,
                             "l1", mode, prec))
    x = x.reshape(z.shape[0], h // 4, w // 4, 512).permute(0, 3, 1, 2)
    for cv, bn in (("l5", "l6"), ("l9", "l10")):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = torch.relu(batchnorm(conv(x, p[f"{cv}.kernel"], p[f"{cv}.bias"],
                                      prec), p, bn, mode, prec))
    x = conv(x, p["l12.kernel"], p["l12.bias"], prec)
    if mode == "calibrate":
        x = _standardized_head(p, x)
    return prec.act(torch.sigmoid(x)).permute(0, 2, 3, 1)


def _standardized_head(p, y):
    """Scale G's output convolution, in place, so that its pre-sigmoid
    output ``y`` has mean 0 and standard deviation 1 per channel over the
    batch; returns ``y`` so scaled."""
    mean, std = y.mean(dim=(0, 2, 3)), y.std(dim=(0, 2, 3))
    p["l12.kernel"].div_(std)
    p["l12.bias"].sub_(mean).div_(std)
    return (y - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)


def r_default(p, images, noise_method: str = "normal",
              prec: Precision = F32, mode: str = "eval"):
    """R_default (models.lua:389-464): NHWC images -> z; its dropouts are
    those of evaluation, ``mode`` is BatchNorm's (:func:`batchnorm`)."""
    x = images.float().permute(0, 3, 1, 2)
    for block in R_BLOCKS:
        for cv, bn in block:
            x = prec.act(F.elu(batchnorm(conv(
                x, p[f"{cv}.kernel"], p[f"{cv}.bias"], prec), p, bn, mode,
                prec)))
        x = F.max_pool2d(x, 2)
    x = prec.act(F.elu(batchnorm(dense(nhwc_flat(x), p["l27.kernel"],
                                       p["l27.bias"], prec), p, "l28", mode,
                                 prec)))
    z = dense(x, p["l31.kernel"], p["l31.bias"], prec)
    return torch.tanh(z) if noise_method != "normal" else z


def _dropout(x, keep, rate):
    return torch.where(keep, x / (1.0 - rate), 0.0)


def d2(p, images, gen: torch.Generator, prec: Precision = F32):
    """D2 in training (models.lua:272-337): NHWC images -> (N,)
    probabilities. The masks are drawn from ``gen`` in the program's order:
    each SpatialDropout one Bernoulli(0.75) per (image, channel), each
    Dropout one per element, by ``torch.rand`` of the NHWC shape."""
    n = images.shape[0]

    def prelu(x, a):
        return prec.act(torch.where(x >= 0, x, p[f"{a}.alpha"] * x))

    def sdrop(x):
        keep = torch.rand((n, 1, 1, x.shape[1]), generator=gen,
                          device=x.device) < 0.75
        return _dropout(x, keep.permute(0, 3, 1, 2), 0.25)

    def drop(x):
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 0.75
        return _dropout(x, keep, 0.25)

    def nxn(x, pre, spatial=True):
        x = prelu(conv(x, p[f"{pre}.l0.kernel"], p[f"{pre}.l0.bias"], prec),
                  f"{pre}.l1")
        return sdrop(x) if spatial else x

    x = images.float().permute(0, 3, 1, 2)
    x = nxn(x, "l0", spatial=False)
    x = F.max_pool2d(nxn(x, "l1"), 2)
    left = F.max_pool2d(nxn(x, "l3.b0.l0"), 2)
    left = drop(prelu(dense(nhwc_flat(left), p["l3.b0.l3.kernel"],
                            p["l3.b0.l3.bias"], prec), "l3.b0.l4"))
    right = F.max_pool2d(nxn(x, "l3.b1.l0"), 2)
    right = F.max_pool2d(nxn(nxn(right, "l3.b1.l2"), "l3.b1.l3"), 2)
    right = prelu(dense(nhwc_flat(right), p["l3.b1.l6.kernel"],
                        p["l3.b1.l6.bias"], prec), "l3.b1.l7")
    x = torch.cat([left, right], dim=1)
    x = drop(prelu(dense(x, p["l4.kernel"], p["l4.bias"], prec), "l5"))
    return prec.act(torch.sigmoid(dense(x, p["l7.kernel"], p["l7.bias"],
                                        prec))).reshape(-1)


def bce(out, target):
    """Binary cross-entropy of probabilities (clamped as the program clamps
    them) against ``target`` (a number or a tensor), the mean."""
    o = out.clamp(BCE_EPS, 1.0 - BCE_EPS)
    return -torch.mean(target * torch.log(o)
                       + (1.0 - target) * torch.log(1.0 - o))


def calibrate_batchnorm(g, r, z, image, noise_method: str = "normal"):
    """Set every BatchNorm's running statistics of G3 (``g``) and of R
    (``r``, where not None), in place, to the statistics of the batch that
    ``z`` and G's images of it make, layer after layer, as training leaves
    them, and scale G's output convolution to logits of unit spread: so
    that each layer's activations in evaluation are normalised, the images
    have a trained G's contrast (at the heuristic init they are grey, their
    pixel cosines within about 1e-6 of each other, below what a float32
    reference can rank) and the embeddings spread."""
    with torch.no_grad(), ieee_f32():
        images = g3(g, z, image, "calibrate")
        if r is not None:
            r_default(r, images, noise_method, mode="calibrate")


# ---------------------------------------------------------------- search

def normalize_rows(x):
    x = x.float()
    return x / torch.sqrt((x * x).sum(-1, keepdim=True)).clamp_min(1e-8)


def search_gaps(emb_ref, picks, values, k: int, block: int = 1024) -> dict:
    """Judge a top-``k`` cosine search of every row against all rows.
    ``emb_ref`` (N, D) are the reference's rows; ``picks`` and ``values``
    (N, k) what the program returned. For each pick, its rank gap is the
    amount by which its reference score lies below the reference's k-th
    best score of that needle (0 where it is in the reference's top k), its
    score gap the distance between the returned score and the reference's
    score of the same pair. Returns the widest rank gap (``rank_max``) and
    the mean rank and score gaps (``rank_mean``, ``score_mean``)."""
    normed = normalize_rows(emb_ref)
    rank_max = rank_sum = score_sum = 0.0
    with ieee_f32():
        for s in range(0, normed.shape[0], block):
            scores = normed[s:s + block] @ normed.T
            kth = torch.topk(scores, k, dim=1).values[:, -1:]
            got = torch.gather(scores, 1, picks[s:s + block].long())
            rank = (kth - got).clamp_min(0)
            rank_max = max(rank_max, float(rank.max()))
            rank_sum += float(rank.sum())
            score_sum += float((values[s:s + block].float() - got).abs().sum())
    return {"rank_max": rank_max, "rank_mean": rank_sum / picks.numel(),
            "score_mean": score_sum / picks.numel()}


# ------------------------------------------------------------ refinement

def refine(p, image, targets, z0, steps: int, lr: float, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-8, prec: Precision = F32):
    """adam on z through G3 in evaluation, minimising each image's pixel
    MSE, with the bias correction folded into the step size as the JAX
    package writes it. Returns (z, per-image loss at the last z)."""
    target = targets.float()
    z = z0.float().clone()
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)

    def loss_of(zz):
        d = g3(p, zz, image, prec=prec) - target
        return (d * d).mean(dim=(1, 2, 3))

    with ieee_f32():
        for t in range(1, steps + 1):
            z.requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(loss_of(z).sum(), z)
            z = z.detach()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
            z = z - step * m / (torch.sqrt(v) + eps)
        with torch.no_grad():
            return z, loss_of(z)


# ------------------------------------------------------ adversarial steps

def _adam(params, grads, state, t, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    step = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
    for name, g in grads.items():
        m = state.setdefault(("m", name), torch.zeros_like(g))
        v = state.setdefault(("v", name), torch.zeros_like(g))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        params[name].data.add_(-step * m / (torch.sqrt(v) + eps))


def _adam_state(adam) -> tuple:
    """(state, steps taken) of :func:`_adam` from ``adam`` ({"m": {name:
    tensor}, "v": {...}, "t": steps}, copied), or fresh where None."""
    if adam is None:
        return {}, 0
    state = {(k, n): t.detach().float().clone()
             for k in ("m", "v") for n, t in adam[k].items()}
    return state, int(adam["t"])


def _regularized(params, grads, loss, l2: float, clamp: float):
    """L2 (loss + w ||p||^2 / 2, grad + w p), then the clamp of every
    gradient element to +-clamp."""
    if l2:
        loss = loss + l2 * sum((q.detach() ** 2).sum()
                               for q in params.values()) / 2.0
        grads = {n: g + l2 * params[n].detach() for n, g in grads.items()}
    if clamp:
        grads = {n: g.clamp(-clamp, clamp) for n, g in grads.items()}
    return grads, loss


def adversarial(g_params, d_params, image, noise_dim: int, reals,
                noise_gen, drop_gen, batch: int, d_l2: float = 1e-4,
                d_clamp: float = 1.0, g_clamp: float = 5.0,
                prec: Precision = F32, adam: dict | None = None):
    """Batches of adversarial training (adversarial.lua:52-195), one per
    entry of ``reals`` (each the half-batch of real NHWC images): a D step
    on the reals and G's fakes from ``batch // 2`` latents, then a G step on
    ``batch`` latents, adam on both, from fresh adam states or from
    ``adam`` ({"G": ..., "D": ...}, each as :func:`_adam_state` takes it).
    Latents are drawn from ``noise_gen`` by ``torch.randn``, D's masks from
    ``drop_gen``, in the program's order. Returns the losses in step order
    (penalties included), the first gradients as each optimizer took them,
    and the parameters after the last batch."""
    g = {n: t.detach().clone().requires_grad_(n.split(".")[-1] not in
                                              ("mean", "var"))
         for n, t in g_params.items()}
    d = {n: t.detach().clone().requires_grad_(True)
         for n, t in d_params.items()}
    g_learn = {n: t for n, t in g.items() if t.requires_grad}
    half = batch // 2
    dev = reals[0].device
    (g_state, t0), (d_state, d_t0) = (_adam_state(None if adam is None
                                                   else adam[m]) for m in "GD")
    assert t0 == d_t0, "G and D take one adam step a batch each"
    losses, first, states = [], {}, (g_state, d_state)
    with ieee_f32():
        for t, real in enumerate(reals, start=t0 + 1):
            z = torch.randn((half, noise_dim), generator=noise_gen,
                            device=dev)
            with torch.no_grad():
                fakes = g3(g, z, image, "train", prec)
            with torch.enable_grad():
                out = d2(d, torch.cat([real.float(), fakes]), drop_gen, prec)
                loss = bce(out, torch.cat([
                    torch.ones(real.shape[0], device=dev),
                    torch.zeros(half, device=dev)]))
                grads = dict(zip(d, torch.autograd.grad(loss, list(
                    d.values()))))
            grads, loss = _regularized(d, grads, loss.detach(), d_l2, d_clamp)
            first.setdefault("D", grads)
            _adam(d, grads, states[1], t)
            losses.append(float(loss))

            z = torch.randn((batch, noise_dim), generator=noise_gen,
                            device=dev)
            with torch.enable_grad():
                loss = bce(d2(d, g3(g, z, image, "train", prec),
                              drop_gen, prec), 1.0)
                grads = dict(zip(g_learn, torch.autograd.grad(
                    loss, list(g_learn.values()))))
            grads, loss = _regularized(g_learn, grads, loss.detach(), 0.0,
                                       g_clamp)
            first.setdefault("G", grads)
            _adam(g_learn, grads, states[0], t)
            losses.append(float(loss))
    params = {"G": {n: t.detach() for n, t in g_learn.items()},
              "D": {n: t.detach() for n, t in d.items()}}
    return losses, first, params
