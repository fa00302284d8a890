"""Adversarial G/D training — the counterpart of
ganreverser_tpu/train/adversarial.py (adversarial.lua:37-205).

Reference semantics kept:

* D's batch is half real (consumed in order from the epoch's data, wrapping
  around like the exampleForDIdx cursor) and half fake from G in training
  mode under ``no_grad`` (its BatchNorm running statistics move); labels
  real = ``Y_NOT_GENERATOR`` = 1, fake = ``Y_GENERATOR`` = 0.
* G's loss is the non-saturating one, D(G(z)) against 1 on a full batch of
  fresh latents; D runs in training mode (dropouts active) but only G's
  parameters get gradients (``torch.autograd.grad`` w.r.t. them), the
  counterpart of the reference's read of D's gradInput.
* Per network the L1 -> L2 -> clamp penalties, then its optimizer
  (defaults D_clamp 1, G_clamp 5, D_L2 1e-4).
* A 2x2 confusion matrix of (D's output > 0.5) against the targets.

The steps take their latents from the caller, so tests can hand both
packages the same numbers. Each step runs its forward and backward under
one ``pinned_precision(dtype)``. Nothing in an epoch waits for the host:
losses and the confusion counts stay on the device until the caller reads
them, once per epoch (the counterpart of JAX's one-dispatch ``lax.scan``
epoch).

With a ``mesh`` (JAX's ``mesh=``, the batches sharded over 'data') every
rank holds the same epoch data and draws the same latents, and keeps rows
``mesh.rows(n)`` of each batch: G runs on its rows of the fake half, the
fakes are all-gathered, and D trains on its rows of the concatenated real
and fake batch; G and D's BatchNorm and dropouts treat the rows as part of
the whole batch (models/modules.py::set_data_parallel, set by the caller),
and losses and gradients are averaged over the 'data' group before the
penalties, so a step on R ranks gives the step of one rank on the whole
batch. Each rank counts the confusion of its rows (the caller sums the
counts over the group). Train states with 'model' shards gather their whole
parameters for each step and update their slices.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.precision import pinned_precision
from ..core.prng import noise_inputs
from ..io.metrics import span
from ..optim import Optimizer, make_optimizer, regularize
from ..parallel.comm import all_gather, pmean
from ..parallel.mesh import Mesh, whole_params
from .losses import bce
from .state import GanState, TrainState

Y_GENERATOR = 0
Y_NOT_GENERATOR = 1


class Confusion:
    """2x2 confusion counts, int32 on the device: rows the actual class
    (0 generated, 1 real), columns the predicted one (optim.ConfusionMatrix,
    adversarial.lua:82-87,199-203)."""

    def __init__(self, counts: torch.Tensor):
        self.counts = counts

    @classmethod
    def zero(cls, device: torch.device | str = "cpu") -> "Confusion":
        return cls(torch.zeros((2, 2), dtype=torch.int32, device=device))

    def add_batch(self, outputs: torch.Tensor,
                  targets: torch.Tensor) -> "Confusion":
        """Count (outputs > 0.5) against the targets, in place, without a
        host sync; returns self."""
        idx = targets.reshape(-1).long() * 2 + (outputs.reshape(-1) > 0.5)
        cells = torch.arange(4, device=idx.device)
        hits = (idx[:, None] == cells).sum(dim=0).to(torch.int32)
        self.counts += hits.reshape(2, 2)
        return self

    @property
    def total_valid(self) -> torch.Tensor:
        """CONFUSION.totalValid, the overall accuracy (adversarial.lua:201),
        an f32 0-d tensor."""
        c = self.counts.float()
        return (c[0, 0] + c[1, 1]) / torch.clamp_min(c.sum(), 1.0)

    def render(self) -> str:
        """The matrix as optim.ConfusionMatrix prints it
        (adversarial.lua:200); reads the counts to the host."""
        host = Confusion(self.counts.cpu())
        c = host.counts.numpy()
        tv = float(host.total_valid)
        return ("ConfusionMatrix:\n"
                f"  [[{c[0, 0]:6d} {c[0, 1]:6d}]   0 (generated)\n"
                f"   [{c[1, 0]:6d} {c[1, 1]:6d}]]  1 (real)\n"
                f"  accuracy (totalValid): {tv:.4f}")


def make_adversarial_steps(*, dtype: torch.dtype, d_l1: float = 0.0,
                           d_l2: float = 1e-4, g_l1: float = 0.0,
                           g_l2: float = 0.0, d_clamp: float = 1.0,
                           g_clamp: float = 5.0,
                           d_optimizer: Optional[Optimizer] = None,
                           g_optimizer: Optional[Optimizer] = None,
                           mesh: Optional[Mesh] = None):
    """Returns ``(d_step, g_step)``, which update ``gs`` (modules,
    optimizer states, step counts) in place:

    d_step(gs, real_half, z, confusion) -> d_loss   (z: the fake half's
                                                     latents; adds to
                                                     ``confusion``)
    g_step(gs, z) -> g_loss                         (z: a full batch)

    Losses are f32 0-d device tensors with the penalty terms. ``dtype`` is
    the models' compute dtype; the dropouts of D draw from the generator
    set on it (``modules.set_dropout_generator``). With ``mesh`` the steps
    take the whole batch's reals and latents and train on this rank's rows
    (module docstring)."""
    d_opt = d_optimizer or make_optimizer("adam")
    g_opt = g_optimizer or make_optimizer("adam")

    def rows(x: torch.Tensor) -> torch.Tensor:
        return x if mesh is None else x[mesh.rows(x.shape[0])]

    def update(ts: TrainState, opt: Optimizer, params: list, grads,
               loss: torch.Tensor, l1: float, l2: float, clamp: float):
        """The mean over the 'data' group, the penalties, the update;
        returns the loss with its penalty terms."""
        with span("gr.optim.update"):
            grads, loss = list(grads), loss.detach()
            if mesh is not None:
                grads, loss = pmean((grads, loss), mesh)
            grads, loss = regularize(params, grads, loss, l1, l2, clamp)
            grads, tensors = ts.update_targets(grads)
            opt.update(grads, ts.opt_state, tensors)
            ts.step += 1
            return loss

    def d_step(gs: GanState, real_half: torch.Tensor, z: torch.Tensor,
               confusion: Confusion) -> torch.Tensor:
        G, D = gs.g.module.train(), gs.d.module.train()
        half = z.shape[0]
        with span("gr.train.d_step"), whole_params(gs.g, gs.d):
            params = list(D.parameters())
            with pinned_precision(dtype):
                with torch.no_grad():
                    # adversarial.lua:140, G's BN statistics move
                    fakes = G(rows(z))
                    if mesh is not None:
                        fakes = all_gather(fakes, mesh)
                inputs = rows(torch.cat([real_half.to(fakes.dtype), fakes]))
                targets = rows(torch.cat([
                    torch.full((real_half.shape[0],), float(Y_NOT_GENERATOR),
                               device=z.device),
                    torch.full((half,), float(Y_GENERATOR),
                               device=z.device)]))
                out = D(inputs).reshape(-1)
                loss = bce(out, targets)
                grads = torch.autograd.grad(loss, params)
            loss = update(gs.d, d_opt, params, grads, loss, d_l1, d_l2,
                          d_clamp)
            confusion.add_batch(out.detach(), targets)
            return loss

    def g_step(gs: GanState, z: torch.Tensor) -> torch.Tensor:
        G, D = gs.g.module.train(), gs.d.module.train()
        with span("gr.train.g_step"), whole_params(gs.g, gs.d):
            params = list(G.parameters())
            with pinned_precision(dtype):
                out = D(G(rows(z))).reshape(-1)
                loss = bce(out, torch.full(out.shape, float(Y_NOT_GENERATOR),
                                           device=out.device))
                grads = torch.autograd.grad(loss, params)
            return update(gs.g, g_opt, params, grads, loss, g_l1, g_l2,
                          g_clamp)

    return d_step, g_step


def train_epoch(d_step: Callable, g_step: Callable, gs: GanState,
                train_data: torch.Tensor, noise: Callable[[int], torch.Tensor],
                *, batch_size: int, n_batches: int, d_iterations: int = 1,
                g_iterations: int = 1, confusion: Optional[Confusion] = None,
                should_stop: Optional[Callable[[], bool]] = None):
    """One epoch, the adversarial.train loop (adversarial.lua:
    52-195): per batch ``d_iterations`` D steps, then ``g_iterations`` G
    steps. ``train_data`` (N, H, W, C) lies on the device; the real halves
    are ``arange(need) % N`` in order, gathered once. ``noise(n)`` draws n
    latents. ``should_stop`` is checked between batches (the epoch ends
    early when it says so). Returns ``(confusion, (d_losses, g_losses))``,
    all on the device."""
    half = batch_size // 2
    need = n_batches * d_iterations * half
    device = train_data.device
    with span("gr.train.epoch"):
        idx = torch.arange(need, device=device) % train_data.shape[0]
        reals = train_data[idx].reshape(
            (n_batches, d_iterations, half) + tuple(train_data.shape[1:]))
        confusion = (confusion if confusion is not None
                     else Confusion.zero(device))
        d_losses, g_losses = [], []
        for b in range(n_batches):
            if should_stop is not None and should_stop():
                break
            for i in range(d_iterations):
                d_losses.append(d_step(gs, reals[b, i], noise(half),
                                       confusion))
            for _ in range(g_iterations):
                g_losses.append(g_step(gs, noise(batch_size)))
        if not d_losses:  # stopped before the first batch
            d_losses = g_losses = [torch.zeros((), device=device)]
        return confusion, (torch.stack(d_losses), torch.stack(g_losses))


def make_epoch_program(*, batch_size: int, noise_dim: int, noise_method: str,
                       n_batches: int, dtype: torch.dtype,
                       d_iterations: int = 1, g_iterations: int = 1,
                       mesh: Optional[Mesh] = None,
                       **penalties) -> Callable:
    """Returns ``epoch(gs, confusion, train_data, generator) -> (d_losses,
    g_losses)``: the whole epoch of :func:`train_epoch`, the latents of
    every step drawn from ``generator`` in step order (on the device of
    ``train_data``), ``confusion`` counted in place; losses of shape
    (n_batches * d_iterations,) and (n_batches * g_iterations,) stay on the
    device. ``mesh`` and ``penalties`` go to
    :func:`make_adversarial_steps`."""
    d_step, g_step = make_adversarial_steps(dtype=dtype, mesh=mesh,
                                            **penalties)

    def epoch(gs: GanState, confusion: Confusion, train_data: torch.Tensor,
              generator: torch.Generator):
        def noise(n):
            return noise_inputs(generator, n, noise_dim, noise_method,
                                device=train_data.device)

        _, losses = train_epoch(
            d_step, g_step, gs, train_data, noise, batch_size=batch_size,
            n_batches=n_batches, d_iterations=d_iterations,
            g_iterations=g_iterations, confusion=confusion)
        return losses

    return epoch
