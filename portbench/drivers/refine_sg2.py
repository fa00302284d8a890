"""Latent refinement through StyleGAN2 config F
(``models/zoo.py::create_G_sg2f``) by the port's own refiner
(``analysis/refine.py::make_refiner``): adam on z through the frozen G,
torch autograd, the gradient reaching z through the activations and every
layer's style and demodulation. Each step refines one chunk of ``chunk``
rows for ``steps`` adam steps; its unit is the image.

Set-up makes the weights on the card from the seed
(``reference_sg2.make``) and a pool of ``pool_chunks`` chunks of targets:
the reference's generator (float32) on latents drawn from the seed, and
first guesses that lie ``guess_noise`` (a standard deviation) from those
latents. The window refines the pool's chunks in turn, as
``drivers/refine.py`` does (its ``step`` and ``release`` serve here).
``check_chunks`` of the window's chunks, drawn from the seed, are judged
after the window against the reference's refinement of the same chunk in
float32, in blocks of ``REF_BLOCK`` rows. The control is that reference
refinement computed in float8 (``reference.FP8``) in the program's place.
"""
from __future__ import annotations

import torch

from .. import reference, reference_sg2, work_sg2
from ..harness import Reservoir, generator
from .refine import _chunk, release, step, units_per_step  # noqa: F401

SYNC_EACH_STEP = True
REF_BLOCK = 4  # rows the reference refines at once (float32 at 1024 x 1024)


def _cfg(cell) -> dict:
    return reference_sg2.config(cell.config)


def prepare(cell) -> dict:
    """The weights, the pool's targets and first guesses."""
    cfg, tr, dev = _cfg(cell), cell.traffic, cell.device
    p = reference_sg2.make(cfg, generator(cell.seed, 0, dev), dev)
    chunk, pool = int(tr["chunk"]), int(tr["pool_chunks"])
    data = generator(cell.seed, 1, dev)
    z_true = torch.randn((pool * chunk, cfg["noise_dim"]), generator=data,
                         device=dev)
    z0 = z_true + float(tr["guess_noise"]) * torch.randn(
        z_true.shape, generator=data, device=dev)
    with torch.no_grad():
        targets = torch.cat([
            reference_sg2.generator(p, z_true[s:s + REF_BLOCK], cfg)
            for s in range(0, pool * chunk, REF_BLOCK)])
    return {"p": p, "targets": targets.split(chunk), "z0": z0.split(chunk)}


def setup(cell, inputs):
    from ganreverser_tpu_torch.analysis.refine import make_refiner
    from ganreverser_tpu_torch.models.zoo import create_G_sg2f
    cfg, tr, dev = _cfg(cell), cell.traffic, cell.device
    dtype = getattr(torch, cell.config["compute_dtype"])
    p, chunk = inputs["p"], int(tr["chunk"])
    with torch.device(dev):
        G = create_G_sg2f(cfg["image"], cfg["noise_dim"], cfg["w_dim"], dtype,
                          mapping_layers=cfg["mapping_layers"],
                          channel_base=cfg["channel_base"],
                          channel_max=cfg["channel_max"])
    G.load_state_dict(p)
    st = {"cell": cell, **inputs, "G": G, "next": 0,
          "sample": Reservoir(int(tr["check_chunks"]), cell.seed)}
    if cell.control:
        st["refine"] = lambda images, z: reference_sg2.refine(
            p, cfg, images, z, int(tr["steps"]), float(tr["lr"]),
            prec=reference.FP8, block=REF_BLOCK)
    else:
        st["refine"] = make_refiner(G, steps=int(tr["steps"]),
                                    lr=float(tr["lr"]), dtype=dtype,
                                    batch_size=chunk)
    for _ in range(int(tr["warmup_steps"])):
        _chunk(st)
    return st


def check(st) -> dict:
    """Over the sampled chunks, as ``drivers/refine.py`` reads them: the
    refined z's distance from the reference's over the reference's move
    from the first guesses, all rows together (``z``) and the widest row's
    over the larger of its move and the median row's (``z_row``); the final
    loss's relative gap, the widest row's (``loss``) and the mean
    (``loss_mean``). Besides, the widest row's relative gap between the
    program's final loss and the reference's loss at the program's own z
    (``loss_at_z``): the forward's precision alone, where adam's first
    steps, which take the sign of every gradient element, carry the
    rounding of small elements of the gradient into ``z`` and ``loss``."""
    cfg, tr = _cfg(st["cell"]), st["cell"].traffic
    out = {"z_row": 0.0, "loss": 0.0, "loss_at_z": 0.0}
    sq = move_sq = loss_sum = 0.0
    rows = 0
    for i, (z, loss) in st["sample"].items:
        z0 = st["z0"][i]
        z_ref, loss_ref = reference_sg2.refine(
            st["p"], cfg, st["targets"][i], z0, int(tr["steps"]),
            float(tr["lr"]), block=REF_BLOCK)
        diff = z.float() - z_ref
        move = (z_ref - z0).norm(dim=1)
        gap = diff.norm(dim=1) / torch.maximum(move, move.median())
        rel = (loss.float() - loss_ref).abs() / loss_ref
        with torch.no_grad():
            d = torch.cat([reference_sg2.generator(
                st["p"], z[s:s + REF_BLOCK].float(), cfg)
                for s in range(0, z.shape[0], REF_BLOCK)]) - st["targets"][i]
        at_z = (d * d).mean(dim=(1, 2, 3))
        out["loss_at_z"] = max(out["loss_at_z"], float(
            ((loss.float() - at_z).abs() / at_z).max()))
        out["z_row"] = max(out["z_row"], float(gap.max()))
        out["loss"] = max(out["loss"], float(rel.max()))
        sq += float((diff * diff).sum())
        move_sq += float((move * move).sum())
        loss_sum += float(rel.sum())
        rows += z.shape[0]
    out["z"] = (sq / move_sq) ** 0.5
    out["loss_mean"] = loss_sum / rows
    return out


def counts(cell) -> dict:
    """Per chunk: G's forward and its backward to the input, at every adam
    step, over the chunk's rows (``work_sg2``)."""
    tr = cell.traffic
    return {"flops_per_step": work_sg2.refine_flops(
        _cfg(cell), int(tr["chunk"]), int(tr["steps"]))}
