"""Faults planted in the program's timed path, to show that a run with one
comes out not correct: the CPU tests (``tests/test_pb_faults.py``) and the
chip's readings of a fault (``calibrate.py --fault <name>``) plant them.

A fault is a function of ``patch(obj, attribute, value)``, which it calls
for every attribute of the program it replaces; :func:`planted` puts the
originals back afterwards. One chip: no fault between chips.
"""
from __future__ import annotations

import contextlib

import torch

from ganreverser_tpu_torch.analysis import e2e, refine
from ganreverser_tpu_torch.optim import optimizers
from ganreverser_tpu_torch.train import adversarial

SETUP_STEPS = 3  # the training cells' ``check_steps``


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` planted, inside the block."""
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    try:
        fault(patch)
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def altered_search(patch):
    """One answer of every search altered where it is produced: the first
    needle's second pick replaced by its least similar row."""
    real = e2e.topk_all

    def topk_all(emb, k, *args, **kw):
        v, i = real(emb, k, *args, **kw)
        normed = torch.nn.functional.normalize(emb.float(), dim=1)
        worst = torch.topk(-(normed @ normed[:1].T)[:, 0], 1).indices
        i = i.clone()
        i[0, 1] = worst[0]
        return v, i
    patch(e2e, "topk_all", topk_all)


def half_batch_e2e(patch):
    """Half of each chunk left out: its rows get the mean of the rest."""
    real = e2e.forward_batched

    def forward_batched(apply_fn, x, batch_size):
        def half(chunk):
            h = chunk.shape[0] // 2
            out = apply_fn(chunk[:h])
            parts = out if isinstance(out, tuple) else (out,)
            full = tuple(torch.cat([p, p.float().mean(0, keepdim=True)
                                    .to(p.dtype).expand_as(p)]) for p in parts)
            return full if isinstance(out, tuple) else full[0]
        return real(half, x, batch_size)
    patch(e2e, "forward_batched", forward_batched)


def refine_unchanged(patch):
    """The refinement returns its state unchanged (no adam step taken)."""
    real = refine.make_refiner
    patch(refine, "make_refiner",
          lambda G, **kw: real(G, **{**kw, "steps": 0}))


def refine_half_batch(patch):
    """Half of each chunk refined, the other rows left as they came."""
    real = refine.make_refiner

    def make_refiner(G, **kw):
        fn = real(G, **kw)

        def run(images, z0):
            h = images.shape[0] // 2
            z, loss = fn(images[:h], z0[:h])
            rest = real(G, **{**kw, "steps": 0})(images[h:], z0[h:])
            return torch.cat([z, rest[0]]), torch.cat([loss, rest[1]])
        return run
    patch(refine, "make_refiner", make_refiner)


def refine_altered(patch):
    """One row's final loss altered where it is produced."""
    real = refine.make_refiner

    def make_refiner(G, **kw):
        fn = real(G, **kw)

        def run(images, z0):
            z, loss = fn(images, z0)
            return z, torch.cat([loss[:1] * 1.5, loss[1:]])
        return run
    patch(refine, "make_refiner", make_refiner)


def _optimizers_applying(patch, applied):
    """Every optimizer made from here on updates its state for its first
    ``applied`` calls and leaves it unchanged after."""
    import ganreverser_tpu_torch.optim as optim
    real = optim.make_optimizer

    def make_optimizer(method, **kw):
        opt, calls = real(method, **kw), [0]

        def update(grads, state, params):
            calls[0] += 1
            if calls[0] <= applied:
                opt.update(grads, state, params)
        return optimizers.Optimizer(opt.init, update)
    patch(optim, "make_optimizer", make_optimizer)


def train_unchanged(patch):
    """The optimizer step returns the state unchanged."""
    _optimizers_applying(patch, 0)


def train_frozen_after_setup(patch):
    """The optimizer step leaves the state unchanged once set-up's checked
    batches are done: a step captured in warm-up whose replay writes
    nothing back."""
    _optimizers_applying(patch, SETUP_STEPS)


def train_half_batch(patch):
    """Half of each batch left out of the loss, the mean taken over the
    rest."""
    real = adversarial.bce
    patch(adversarial, "bce", lambda out, target: real(
        out[:out.shape[0] // 2], target[:target.shape[0] // 2]))


def train_altered(patch):
    """Each step's loss altered (by a tenth) where it is produced."""
    real = adversarial.bce
    patch(adversarial, "bce", lambda out, target: real(out, target) * 1.1)


# the faults that a cell of each driver can have
OF_DRIVER = {
    "e2e": (altered_search, half_batch_e2e),
    "refine": (refine_unchanged, refine_half_batch, refine_altered),
    "train_gd": (train_unchanged, train_frozen_after_setup, train_half_batch,
                 train_altered),
}
