"""Uniform model interface over the families ported so far (``linear``).

- ``init(cfg, device, generator)``: the parameter dict on ``device``.
- ``make_loss(cfg)``: ``fn(params, batch) -> scalar``; ``batch`` is always a
  dict (x/y for linear).
- ``make_forward(cfg)``: ``fn(params, batch) -> per-request output``.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from . import linear

_FAMILY = {
    "linear": linear,
}


def get_module(cfg):
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; ported so far: "
            f"{sorted(_FAMILY)}") from None


def init(cfg, device: str | torch.device = "cuda",
         generator: torch.Generator | None = None):
    """Initial parameters on ``device`` (default: the card; raises when
    there is none).  ``generator`` seeds families with random init."""
    return get_module(cfg).init(cfg, resolve_device(device), generator)


def make_loss(cfg):
    mod = get_module(cfg)

    def fn(params, batch):
        return mod.loss(params, cfg, batch)

    return fn


def make_forward(cfg):
    """Returns fn(params, batch) -> per-request output: for the linear
    family the ``(B,)`` logit vector."""
    mod = get_module(cfg)

    def fn(params, batch):
        return mod.logits(params, cfg, batch["x"])

    return fn
