"""The fused generate -> invert -> top-k program
(``analysis/e2e.py::make_e2e_program`` on the fast legs of ``fast_legs``,
one CUDA graph): each step is one call on ``n`` fresh latents drawn from
the seed; its unit is the image.

Set-up makes G3's and R's weights on the card, calibrated as training
leaves them (``reference.calibrate_batchnorm``), builds the program and
makes its first call (the graph's capture) and ``warmup_steps`` more. The
window's calls are sampled (``check_calls`` of them, drawn from the seed)
and judged after the window against the reference run on the same latents
in float32: R's embeddings, then each search's picks and scores
(``reference.search_gaps``). The control is the program on its int8 legs
(kernels Q1-Q4).
"""
from __future__ import annotations

import torch

from .. import reference, weights, work
from ..harness import Reservoir, generator

SYNC_EACH_STEP = True
REF_BLOCK = 512  # rows of the reference's forward at a time


def units_per_step(cell) -> int:
    return int(cell.traffic["n"])


def prepare(cell) -> dict:
    """G3's and R's weights, BatchNorm calibrated."""
    cfg, dev = cell.config, cell.device
    image, zd = tuple(cfg["image"]), int(cfg["noise_dim"])
    gen = generator(cell.seed, 0, dev)
    g = weights.make(weights.g3_leaves(image, zd), gen, dev)
    r = weights.make(weights.r_leaves(image, zd), gen, dev)
    z = torch.randn((reference.CALIBRATION, zd), generator=gen, device=dev)
    reference.calibrate_batchnorm(g, r, z, image, cfg["noise_method"])
    return {"g": g, "r": r}


def setup(cell, inputs):
    from ganreverser_tpu_torch.analysis import e2e
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    image, zd = tuple(cfg["image"]), int(cfg["noise_dim"])
    g, r = inputs["g"], inputs["r"]
    legs = e2e.fast_legs(image, zd, cfg["noise_method"],
                         getattr(torch, cfg["compute_dtype"]),
                         int8=cell.control)
    program = e2e.make_e2e_program(
        None, None, batch_size=int(tr["batch"]), k=int(tr["k"]),
        needle_chunk=int(tr["needle_chunk"]), pixel_k=int(tr["pixel_k"]),
        **legs)
    st = {"cell": cell, "g": g, "r": r, "program": program,
          "g_vars": weights.nested(g), "r_vars": weights.nested(r),
          "z_gen": generator(cell.seed, 1, dev),
          "sample": Reservoir(int(tr["check_calls"]), cell.seed)}
    for _ in range(1 + int(tr["warmup_steps"])):
        _call(st)
    return st


def _call(st):
    cell = st["cell"]
    z = torch.randn((int(cell.traffic["n"]), int(cell.config["noise_dim"])),
                    generator=st["z_gen"], device=cell.device)
    return z, st["program"](st["g_vars"], st["r_vars"], z)


def step(st):
    st["sample"].offer(_call(st))


def release(st):
    st["program"] = st["g_vars"] = st["r_vars"] = None


def _reference(st, z):
    """The reference's embeddings of ``z`` and, with the pixel measure, its
    flat images."""
    cell = st["cell"]
    image = tuple(cell.config["image"])
    pixels = int(cell.traffic["pixel_k"]) > 0
    embs, flats = [], []
    with torch.no_grad(), reference.ieee_f32():
        for s in range(0, z.shape[0], REF_BLOCK):
            images = reference.g3(st["g"], z[s:s + REF_BLOCK].float(), image)
            embs.append(reference.r_default(st["r"], images,
                                            cell.config["noise_method"]))
            if pixels:
                flats.append(images.reshape(images.shape[0], -1))
    return torch.cat(embs), (torch.cat(flats) if pixels else None)


def check(st) -> dict:
    """Over the sampled calls: R's embeddings against the reference's, the
    distance of all rows over the reference's norm (``emb``); and each
    search's gaps (``reference.search_gaps``), under ``knn_`` (the latents)
    and ``pixel_``."""
    tr = st["cell"].traffic
    out, sq, ref_sq = {}, 0.0, 0.0
    for z, got in st["sample"].items:
        emb_ref, flat_ref = _reference(st, z)
        diff = got[0].float() - emb_ref
        sq += float((diff * diff).sum())
        ref_sq += float((emb_ref * emb_ref).sum())
        searches = [("knn", emb_ref, got[1], got[2], int(tr["k"]))]
        if flat_ref is not None:
            searches.append(("pixel", flat_ref, got[3], got[4],
                             int(tr["pixel_k"])))
        for name, ref, values, picks, k in searches:
            for key, value in reference.search_gaps(ref, picks, values,
                                                    k).items():
                key = f"{name}_{key}"
                out[key] = max(out.get(key, 0.0), value)
    out["emb"] = (sq / ref_sq) ** 0.5
    return out


def counts(cell) -> dict:
    """Per call: the necessary operations (G's and R's forwards and both
    searches' score products) and, per kind of hand-written kernel
    (``kernels.json``), the least time of the layers it computes."""
    cfg, tr = cell.config, cell.traffic
    image, zd = tuple(cfg["image"]), int(cfg["noise_dim"])
    n, b = int(tr["n"]), int(tr["batch"])
    g, r = work.g3_layers(image, zd), work.r_layers(image, zd)
    c, h, w = image
    searches = [zd] + ([c * h * w] if int(tr["pixel_k"]) > 0 else [])
    flops = (n * (work.forward_flops(g) + work.forward_flops(r))
             + sum(2 * n * n * d for d in searches))
    chunks = work.chunks(n, b)
    r_convs = [layer for layer in r if layer.name.startswith("R.conv")]
    bounds = {
        "conv_block": chunks * sum(work.layer_bound_s(layer, b)
                                   for layer in r_convs),
        "upsample": chunks * work.layer_bound_s(g[1], b),
        "upsample_head": chunks * work.fused_bound_s(g[2:], b),
        "cosine": sum(work.score_bound_s(q, n, d) for d in searches
                      for q in work.needle_chunks(n, int(
                          tr["needle_chunk"]))),
    }
    return {"flops_per_step": flops, "kernel_bounds_s": bounds}
