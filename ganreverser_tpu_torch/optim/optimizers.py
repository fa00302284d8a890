"""The six optimizers of ganreverser_tpu/optim/optimizers.py — torch optim's
sgd, adagrad, adadelta, adamax, adam and rmsprop with their defaults — as
in-place updates of a list of parameters.

    opt = adam()
    state = opt.init(params)             # params: a list of tensors
    opt.update(grads, state, params)     # grads: a list aligned with params

The state is a dict with the JAX package's keys: per-parameter leaves are
lists aligned with ``params``, and a step count is an int32 0-d tensor on
the parameters' device, so an update never waits for the host. Each formula
is the JAX package's, operation for operation, written with
``torch._foreach_*`` (a few launches per update for all parameters). adam
folds the bias correction into the step size, ``lr sqrt(1 - b2^t) /
(1 - b1^t)``, which places eps differently from ``torch.optim.Adam``; that
class is therefore not used.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[list], dict]
    update: Callable[[list, dict, list], None]


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _step0(params):
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def _scaled(xs, c):
    return torch._foreach_mul(xs, c)


def _decayed(grads, params, weight_decay):
    """g + weight_decay * p."""
    if weight_decay == 0.0:
        return grads
    return torch._foreach_add(grads, _scaled(params, weight_decay))


def _ema_(acc, rho, xs):
    """acc = rho * acc + (1 - rho) * xs, in place."""
    torch._foreach_mul_(acc, rho)
    torch._foreach_add_(acc, _scaled(xs, 1.0 - rho))


def _ema_sq_(acc, rho, g):
    """acc = rho * acc + (1 - rho) * g * g, in place."""
    torch._foreach_mul_(acc, rho)
    torch._foreach_add_(acc, torch._foreach_mul(_scaled(g, 1.0 - rho), g))


def _descend_(params, num, den, eps):
    """p += num / (sqrt(den) + eps)."""
    root = torch._foreach_sqrt(den)
    torch._foreach_add_(root, eps)
    torch._foreach_div_(num, root)
    torch._foreach_add_(params, num)


def sgd(lr: float = 1e-3, momentum: float = 0.0, dampening: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False,
        lr_decay: float = 0.0) -> Optimizer:
    """torch optim.sgd; the reference passes lr/momentum from the CLI."""

    def init(params):
        return {"step": _step0(params), "mom": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        clr = lr / (1.0 + step.float() * lr_decay)
        g = _decayed(grads, params, weight_decay)
        if momentum != 0.0:
            m = state["mom"]
            torch._foreach_mul_(m, momentum)
            torch._foreach_add_(m, _scaled(g, 1.0 - dampening))
            d = (torch._foreach_add(g, _scaled(m, momentum)) if nesterov
                 else m)
        else:
            d = g
        torch._foreach_add_(params, _scaled(d, -clr))
        step.add_(1)

    return Optimizer(init, update)


def adagrad(lr: float = 1e-2, lr_decay: float = 0.0,
            weight_decay: float = 0.0, eps: float = 1e-10) -> Optimizer:
    """torch optim.adagrad; the accumulator takes the decayed gradient."""

    def init(params):
        return {"step": _step0(params), "acc": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        clr = lr / (1.0 + step.float() * lr_decay)
        g = _decayed(grads, params, weight_decay)
        torch._foreach_add_(state["acc"], torch._foreach_mul(g, g))
        _descend_(params, _scaled(g, -clr), state["acc"], eps)
        step.add_(1)

    return Optimizer(init, update)


def adadelta(rho: float = 0.9, eps: float = 1e-6,
             weight_decay: float = 0.0) -> Optimizer:
    """torch optim.adadelta (no learning rate)."""

    def init(params):
        return {"acc_g": _zeros(params), "acc_d": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        g = _decayed(grads, params, weight_decay)
        ag, ad = state["acc_g"], state["acc_d"]
        _ema_sq_(ag, rho, g)
        # d = -sqrt(ad + eps) / sqrt(ag + eps) * g
        d = torch._foreach_neg(torch._foreach_sqrt(torch._foreach_add(ad, eps)))
        torch._foreach_div_(d, torch._foreach_sqrt(torch._foreach_add(ag, eps)))
        torch._foreach_mul_(d, g)
        _ema_sq_(ad, rho, d)
        torch._foreach_add_(params, d)

    return Optimizer(init, update)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """torch optim.adam; the optimizer of R (train_r.lua:170)."""

    def init(params):
        return {"step": _step0(params), "m": _zeros(params),
                "v": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        step.add_(1)
        t = step.float()
        step_size = lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        g = _decayed(grads, params, weight_decay)
        _ema_(state["m"], b1, g)
        _ema_sq_(state["v"], b2, g)
        _descend_(params, _scaled(state["m"], -step_size), state["v"], eps)

    return Optimizer(init, update)


def adamax(lr: float = 2e-3, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-38, weight_decay: float = 0.0) -> Optimizer:
    """torch optim.adamax (the infinity-norm variant)."""

    def init(params):
        return {"step": _step0(params), "m": _zeros(params),
                "u": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        step.add_(1)
        step_size = lr / (1.0 - b1 ** step.float())
        g = _decayed(grads, params, weight_decay)
        m, u = state["m"], state["u"]
        _ema_(m, b1, g)
        torch._foreach_mul_(u, b2)
        abs_g = torch._foreach_abs(g)
        torch._foreach_add_(abs_g, eps)
        torch._foreach_maximum_(u, abs_g)
        num = _scaled(m, -step_size)
        torch._foreach_div_(num, u)
        torch._foreach_add_(params, num)

    return Optimizer(init, update)


def rmsprop(lr: float = 1e-2, alpha: float = 0.99, eps: float = 1e-8,
            weight_decay: float = 0.0) -> Optimizer:
    """torch optim.rmsprop."""

    def init(params):
        return {"ms": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        g = _decayed(grads, params, weight_decay)
        _ema_sq_(state["ms"], alpha, g)
        _descend_(params, _scaled(g, -lr), state["ms"], eps)

    return Optimizer(init, update)


def make_optimizer(method: str, *, sgd_lr: float = 0.02,
                   sgd_momentum: float = 0.0) -> Optimizer:
    """The adversarial.lua:147-188 dispatch table: only sgd takes CLI
    hyperparameters; the rest use torch's defaults."""
    if method == "sgd":
        return sgd(lr=sgd_lr, momentum=sgd_momentum)
    makers = {"adagrad": adagrad, "adadelta": adadelta, "adamax": adamax,
              "adam": adam, "rmsprop": rmsprop}
    if method not in makers:
        raise ValueError(f"Unknown optimizer method {method!r}")
    return makers[method]()
