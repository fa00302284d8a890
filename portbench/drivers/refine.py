"""Latent refinement (``analysis/refine.py::make_refiner``): adam on z
through the module G in evaluation, frozen, with torch autograd. Each step
refines one chunk of ``chunk`` rows for ``steps`` adam steps; its unit is
the image.

Set-up makes G3's weights on the card, calibrated as training leaves them
(``reference.calibrate_batchnorm``), and a pool of ``pool_chunks`` chunks
of targets: the reference's G3 (float32) on latents drawn from the seed, and
first guesses that lie ``guess_noise`` (a standard deviation) from those
latents, as a trained R's would. The window refines the pool's chunks in
turn. ``check_chunks`` of the window's chunks, drawn from the seed, are
judged after the window against the reference's refinement of the same
chunk in float32. The control is that reference refinement computed in
float8 (``reference.FP8``) in the program's place.
"""
from __future__ import annotations

import torch

from .. import reference, weights, work
from ..harness import Reservoir, generator

SYNC_EACH_STEP = True


def units_per_step(cell) -> int:
    return int(cell.traffic["chunk"])


def prepare(cell) -> dict:
    """G3's weights (BatchNorm calibrated), the pool's targets and first
    guesses."""
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    image, zd = tuple(cfg["image"]), int(cfg["noise_dim"])
    gen = generator(cell.seed, 0, dev)
    g = weights.make(weights.g3_leaves(image, zd), gen, dev)
    z = torch.randn((reference.CALIBRATION, zd), generator=gen, device=dev)
    reference.calibrate_batchnorm(g, None, z, image)
    chunk, pool = int(tr["chunk"]), int(tr["pool_chunks"])
    data = generator(cell.seed, 1, dev)
    z_true = torch.randn((pool * chunk, zd), generator=data, device=dev)
    z0 = z_true + float(tr["guess_noise"]) * torch.randn(
        z_true.shape, generator=data, device=dev)
    with torch.no_grad(), reference.ieee_f32():
        targets = torch.cat([reference.g3(g, z_true[s:s + chunk], image)
                             for s in range(0, pool * chunk, chunk)])
    return {"g": g, "targets": targets.split(chunk), "z0": z0.split(chunk)}


def setup(cell, inputs):
    from ganreverser_tpu_torch.analysis.refine import make_refiner
    from ganreverser_tpu_torch.models.zoo import create_G3
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    image, zd = tuple(cfg["image"]), int(cfg["noise_dim"])
    dtype = getattr(torch, cfg["compute_dtype"])
    g, chunk = inputs["g"], int(tr["chunk"])
    with torch.device(dev):
        G = create_G3(image, zd, dtype)
    G.load_state_dict(g)
    st = {"cell": cell, **inputs, "G": G, "next": 0,
          "sample": Reservoir(int(tr["check_chunks"]), cell.seed)}
    if cell.control:
        st["refine"] = lambda images, z: reference.refine(
            g, image, images, z, int(tr["steps"]), float(tr["lr"]),
            prec=reference.FP8)
    else:
        st["refine"] = make_refiner(G, steps=int(tr["steps"]),
                                    lr=float(tr["lr"]), dtype=dtype,
                                    batch_size=chunk)
    for _ in range(int(tr["warmup_steps"])):
        _chunk(st)
    return st


def _chunk(st):
    i = st["next"] % len(st["targets"])
    st["next"] += 1
    return i, st["refine"](st["targets"][i], st["z0"][i])


def step(st):
    st["sample"].offer(_chunk(st))


def release(st):
    st["G"] = st["refine"] = None


def check(st) -> dict:
    """Over the sampled chunks: the refined z's distance from the
    reference's over the reference's move from the first guesses, all rows
    together (``z``) and the widest row's over the larger of its move and
    the median row's (``z_row``); the final loss's relative gap, the widest
    row's (``loss``) and the mean (``loss_mean``)."""
    tr = st["cell"].traffic
    image = tuple(st["cell"].config["image"])
    out = {"z_row": 0.0, "loss": 0.0}
    sq = move_sq = loss_sum = 0.0
    rows = 0
    for i, (z, loss) in st["sample"].items:
        z0 = st["z0"][i]
        z_ref, loss_ref = reference.refine(st["g"], image, st["targets"][i],
                                           z0, int(tr["steps"]),
                                           float(tr["lr"]))
        diff = z.float() - z_ref
        move = (z_ref - z0).norm(dim=1)
        gap = diff.norm(dim=1) / torch.maximum(move, move.median())
        rel = (loss.float() - loss_ref).abs() / loss_ref
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
    step, over the chunk's rows."""
    cfg, tr = cell.config, cell.traffic
    g = work.g3_layers(tuple(cfg["image"]), int(cfg["noise_dim"]))
    per_image = work.train_flops(g, weights=False, inputs_of_first=True)
    return {"flops_per_step": per_image * int(tr["steps"]) * int(tr["chunk"])}
