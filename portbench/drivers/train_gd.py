"""Adversarial G/D training (``train/adversarial.py::make_epoch_program``):
each step is one call of the epoch program with one batch, a D step on
``batch // 2`` real faces and as many fakes, then a G step on ``batch``
latents, adam on both; its unit is the batch. Losses stay on the card.

Set-up makes G3's and D2's weights on the card, a pool of
``pool_batches`` half-batches of procedural faces (``weights.faces``) and
the train state, then drives that state through its first ``check_steps``
batches by the window's own call, on pool rows that all differ, keeping
what the comparison needs: the losses, adam's first moments after the first
batch (the first gradients as the optimizers took them: m / (1 - b1)) and
the parameters after the last. The window goes on with the same state and
the pool's next rows.

Once the window has closed, ``release`` takes a copy of the state the
window left (parameters, G's BatchNorm statistics, adam's m, v and step
count, the latents' and the dropouts' generators) and drives the same state
through ``check_steps`` more batches by the same call, keeping the same
readings (a first gradient there is (m_1 - b1 m_0) / (1 - b1)). The
reference follows the first batches from the benchmark's weights, and the
batches after the window from that copy, in float32: it cannot follow the
window's own batches, whose rounding it does not share, so it checks the
start and the state after the window. The control is that reference
computed in float8 (``reference.FP8``) in the program's place.
"""
from __future__ import annotations

import math
import statistics

import torch

from .. import reference, weights, work
from ..harness import generator

SYNC_EACH_STEP = False
B1 = 0.9  # adam's first-moment decay (optim/optimizers.py's default)


def units_per_step(cell) -> int:
    return 1


def _hyper(tr):
    return {"d_l2": float(tr["d_l2"]), "d_clamp": float(tr["d_clamp"]),
            "g_clamp": float(tr["g_clamp"])}


def prepare(cell) -> dict:
    """G3's and D2's weights and the pool of real faces."""
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    image, zd = tuple(cfg["image"]), int(cfg["noise_dim"])
    gen = generator(cell.seed, 0, dev)
    g = weights.make(weights.g3_leaves(image, zd), gen, dev)
    d = weights.make(weights.d2_leaves(image), gen, dev)
    c, h, w = image
    reals = weights.faces(int(tr["pool_batches"]) * (int(tr["batch"]) // 2),
                          h, w, generator(cell.seed, 1, dev), dev)
    return {"g": g, "d": d, "reals": reals.split(int(tr["batch"]) // 2)}


def setup(cell, inputs):
    from ganreverser_tpu_torch.models.modules import set_dropout_generator
    from ganreverser_tpu_torch.models.zoo import create_D2, create_G3
    from ganreverser_tpu_torch.optim import make_optimizer
    from ganreverser_tpu_torch.train.adversarial import (Confusion,
                                                         make_epoch_program)
    from ganreverser_tpu_torch.train.state import GanState, TrainState
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    image, zd = tuple(cfg["image"]), int(cfg["noise_dim"])
    dtype = getattr(torch, cfg["compute_dtype"])
    g, d = inputs["g"], inputs["d"]
    with torch.device(dev):
        G, D = create_G3(image, zd, dtype), create_D2(image, dtype)
    G.load_state_dict(g)
    D.load_state_dict(d)
    g_opt, d_opt = make_optimizer("adam"), make_optimizer("adam")
    gs = GanState(TrainState.create(G, g_opt), TrainState.create(D, d_opt))
    drop = generator(cell.seed, 3, dev)
    set_dropout_generator(D, drop)
    epoch = make_epoch_program(
        batch_size=int(tr["batch"]), noise_dim=zd,
        noise_method=cfg["noise_method"], n_batches=1, dtype=dtype,
        d_optimizer=d_opt, g_optimizer=g_opt, **_hyper(tr))
    st = {"cell": cell, **inputs, "gs": gs, "epoch": epoch,
          "confusion": Confusion.zero(dev), "noise": generator(cell.seed, 2,
                                                               dev),
          "drop": drop, "next": 0, "losses": []}
    st["early"] = _checked_steps(st)
    if cell.control:
        st["early"] = _reference(st, reference.FP8, None)
    for _ in range(int(tr["warmup_steps"])):
        step(st)
    return st


def _modules(gs):
    return (("G", gs.g), ("D", gs.d))


def _names(ts):
    return [n for n, _ in ts.module.named_parameters()]


def _copy(ts, key):
    return dict(zip(_names(ts), (t.detach().clone()
                                 for t in ts.opt_state[key])))


def _checked_steps(st) -> tuple:
    """``check_steps`` batches by the window's own call: (their losses, the
    first gradient as each optimizer took it, each module's parameters
    after them), as :func:`reference.adversarial` returns them."""
    gs = st["gs"]
    m0 = {m: _copy(ts, "m") for m, ts in _modules(gs)}
    n0 = len(st["losses"])
    for i in range(int(st["cell"].traffic["check_steps"])):
        step(st)
        if i == 0:
            first = {m: {k: (v - B1 * m0[m][k]) / (1 - B1)
                         for k, v in _copy(ts, "m").items()}
                     for m, ts in _modules(gs)}
    losses = [float(x) for pair in st["losses"][n0:]
              for x in (pair[0][0], pair[1][0])]
    after = {m: {n: t.detach().clone()
                 for n, t in ts.module.named_parameters()}
             for m, ts in _modules(gs)}
    return losses, first, after


def step(st):
    reals = st["reals"]
    data = reals[st["next"] % len(reals)]
    st["next"] += 1
    st["losses"].append(st["epoch"](st["gs"], st["confusion"], data,
                                    st["noise"]))


def release(st):
    """The state the window left copied, ``check_steps`` more batches run
    from it by the window's own call, then the program dropped."""
    gs = st["gs"]
    st["start"] = {
        "params": {m: {**{n: t.detach().clone() for n, t in
                          ts.module.named_parameters()},
                       **{n: t.detach().clone() for n, t in
                          ts.module.named_buffers()}}
                   for m, ts in _modules(gs)},
        "adam": {m: {"m": _copy(ts, "m"), "v": _copy(ts, "v"),
                     "t": int(ts.opt_state["step"])}
                 for m, ts in _modules(gs)},
        "noise": st["noise"].get_state(), "drop": st["drop"].get_state(),
        "next": st["next"]}
    st["late"] = _checked_steps(st)
    if st["cell"].control:
        st["late"] = _reference(st, reference.FP8, st["start"])
    st["gs"] = st["epoch"] = None


def _reference(st, prec, start):
    """The reference over the first ``check_steps`` batches from the
    benchmark's weights (``start`` None), or over those after the window
    from the copy ``start``."""
    cell = st["cell"]
    tr, dev = cell.traffic, cell.device
    n = int(tr["check_steps"])
    if start is None:
        params = (st["g"], st["d"])
        noise, drop = generator(cell.seed, 2, dev), generator(cell.seed, 3,
                                                              dev)
        first_row, adam = 0, None
    else:
        params = (start["params"]["G"], start["params"]["D"])
        noise, drop = (torch.Generator(device=dev).set_state(start[k])
                       for k in ("noise", "drop"))
        first_row, adam = start["next"], start["adam"]
    reals = st["reals"]
    rows = [reals[(first_row + i) % len(reals)] for i in range(n)]
    return reference.adversarial(
        *params, tuple(cell.config["image"]), int(cell.config["noise_dim"]),
        rows, noise, drop, int(tr["batch"]), prec=prec, adam=adam,
        **_hyper(tr))


def _ratio(gap: float, scale: float) -> float:
    return gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)


def _norm_gaps(got: dict, ref: dict, keep) -> list:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference's norm of that leaf and of the median kept
    leaf."""
    if not keep:
        return []
    ref_n = {k: float(ref[k].norm()) for k in keep}
    median = torch.tensor(list(ref_n.values())).median().item()
    return [_ratio(abs(float(got[k].float().norm()) - ref_n[k]),
                   max(ref_n[k], median)) for k in keep]


def _gaps(got, ref, init) -> dict:
    """The widest relative gap of the batches' losses (D's and G's,
    penalties included; ``loss``, and of the first batch alone
    ``loss_first``; ``loss_ref_min`` the smallest reference loss), of each
    leaf's first gradient (``grad``) and of each leaf's change over the
    batches (``change``), and the median leaf's of both. Leaves whose
    reference gradient is not above a thousandth of the median leaf's of
    their module are left out of both (biases before a training BatchNorm:
    their gradient is round-off, and adam moves them by round-off alone);
    so is every leaf of a module whose reference gradient vanished (D
    saturated: the loss's clamp passes no gradient)."""
    (p_loss, p_first, p_after), (r_loss, r_first, r_after) = got, ref
    gaps = [abs(p - r) / abs(r) for p, r in zip(p_loss, r_loss)]
    grad_gaps, change_gaps = [], []
    for m in ("G", "D"):
        norms = {k: float(v.norm()) for k, v in r_first[m].items()}
        floor = 1e-3 * torch.tensor(list(norms.values())).median().item()
        moved = [k for k in r_first[m] if norms[k] > floor]
        grad_gaps += _norm_gaps(p_first[m], r_first[m], moved)
        change_gaps += _norm_gaps(
            {k: p_after[m][k] - init[m][k] for k in moved},
            {k: r_after[m][k] - init[m][k] for k in moved}, moved)
    return {"loss": max(gaps), "loss_first": max(gaps[:2]),
            "loss_ref_min": min(abs(r) for r in r_loss),
            "grad": max(grad_gaps, default=0.0),
            "change": max(change_gaps, default=0.0),
            "grad_median": statistics.median(grad_gaps or [0.0]),
            "change_median": statistics.median(change_gaps or [0.0])}


def check(st) -> dict:
    """:func:`_gaps` of the first ``check_steps`` batches, and under
    ``late_`` of the ``check_steps`` batches after the window."""
    early = _gaps(st["early"], _reference(st, reference.F32, None),
                  {"G": st["g"], "D": st["d"]})
    late = _gaps(st["late"], _reference(st, reference.F32, st["start"]),
                 st["start"]["params"])
    return {**early, **{f"late_{k}": v for k, v in late.items()}}


def counts(cell) -> dict:
    """Per batch: the D step (G's forward on the fake half; D's forward and
    its backward to the weights and to every input but the images') and the
    G step (G's forward and backward to the weights and to every input but
    the latents'; D's forward and its backward to the inputs)."""
    cfg, tr = cell.config, cell.traffic
    image, zd = tuple(cfg["image"]), int(cfg["noise_dim"])
    g, d = work.g3_layers(image, zd), work.d2_layers(image)
    b = int(tr["batch"])
    d_step = (b // 2 * work.forward_flops(g)
              + b * work.train_flops(d, weights=True, inputs_of_first=False))
    g_step = b * (work.train_flops(g, weights=True, inputs_of_first=False)
                  + work.train_flops(d, weights=False, inputs_of_first=True))
    return {"flops_per_step": d_step + g_step}
