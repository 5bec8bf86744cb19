"""Gradient-based optimizers as functions on parameter dicts.

NAG (Nesterov's Accelerated Gradient, Bubeck FnT 2015 §3.7) is the paper's
optimizer for the Section-V experiments; SGD-momentum and AdamW cover the
other training paths.  All states are dicts of f32 mirrors so the update
math is stable under bf16 params.  ``update`` returns new dicts and leaves
its inputs untouched (no in-place update: the state so far is a few
vectors, and the trainer drops the old dicts at once).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Params = dict


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], tuple[Params, dict]]
    # update(grads, opt_state, params) -> (new_params, new_opt_state)
    # Introspection for fused decode-plus-apply paths: `kind` names the
    # update rule ("" = opaque, fusion unavailable) and `hyper` carries the
    # scalar hyperparameters a kernel needs to replicate it.
    kind: str = ""
    hyper: dict | None = None


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.float32)


def _scalar(value, dtype, like: Params) -> torch.Tensor:
    dev = next(iter(like.values())).device
    return torch.zeros((), dtype=dtype, device=dev) + value


def nag(lr: float) -> Optimizer:
    """Nesterov's accelerated gradient with the paper's (Bubeck §3.7)
    lambda-sequence: x_{k+1} = y_k - lr*g(y_k);
    y_{k+1} = x_{k+1} + gamma_k (x_{k+1} - x_k).  Params carried = y.
    ``lam`` stays an f32 scalar tensor on the params' device."""

    def init(params):
        return {"x_prev": {k: _f32(p).clone() for k, p in params.items()},
                "lam": _scalar(0.0, torch.float32, params)}

    def update(grads, state, params):
        lam = state["lam"]
        lam_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * lam * lam))
        gamma = (lam - 1.0) / lam_next
        new_params, new_x = {}, {}
        for k, y in params.items():
            x_new = _f32(y) - lr * _f32(grads[k])
            y_new = x_new + gamma * (x_new - state["x_prev"][k])
            new_params[k] = y_new.to(y.dtype)
            new_x[k] = x_new
        return new_params, {"x_prev": new_x, "lam": lam_next}

    return Optimizer(init, update)


def sgd_momentum(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()}}

    def update(grads, state, params):
        mu = {k: momentum * state["mu"][k] + _f32(grads[k]) for k in params}
        new = {k: (_f32(p) - lr * mu[k]).to(p.dtype)
               for k, p in params.items()}
        return new, {"mu": mu}

    return Optimizer(init, update, kind="sgd",
                     hyper={"lr": float(lr), "momentum": float(momentum)})


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def z():
            return {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
        return {"m": z(), "v": z(), "t": _scalar(0, torch.int32, params)}

    def update(grads, state, params):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1.0 - b1 ** tf
        bc2 = 1.0 - b2 ** tf
        m = {k: b1 * state["m"][k] + (1 - b1) * _f32(grads[k])
             for k in params}
        v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(_f32(grads[k]))
             for k in params}
        new = {}
        for k, p in params.items():
            step = lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
            p32 = _f32(p)
            if weight_decay:
                step = step + lr * weight_decay * p32
            new[k] = (p32 - step).to(p.dtype)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return {"nag": nag, "sgd": sgd_momentum, "adamw": adamw}[name](lr, **kw)
