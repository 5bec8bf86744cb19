"""Uniform model interface over the families ported so far (``linear``,
``dense``).

- ``init(cfg, device, generator)``: the parameter dict on ``device``.
- ``make_loss(cfg)``: ``fn(params, batch) -> scalar``; ``batch`` is always a
  dict (x/y for linear, tokens/labels for dense).
- ``make_prefill(cfg, cache_len, window)``: ``fn(params, batch) ->
  (last-token logits, cache)`` for the LM families.
- ``make_forward(cfg, window)``: ``fn(params, batch) -> per-request output``,
  the unit of work coded serving shards across replicas.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from . import dense, linear

_FAMILY = {
    "dense": dense,
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
    there is none).  ``generator`` seeds families with random init; on the
    ``meta`` device the parameters have their shapes and types and nothing
    is drawn or allocated."""
    return get_module(cfg).init(cfg, resolve_device(device), generator)


def make_loss(cfg):
    mod = get_module(cfg)
    if not hasattr(mod, "loss"):
        raise NotImplementedError(
            f"the loss of model family {cfg.family!r} is not ported yet")

    def fn(params, batch):
        return mod.loss(params, cfg, batch)

    return fn


def make_prefill(cfg, cache_len: int, *, window: int = 0):
    """Returns fn(params, batch) -> (last-token logits, cache); batch:
    ``{"tokens": (B, S)}``."""
    mod = get_module(cfg)
    if not hasattr(mod, "prefill"):
        raise NotImplementedError(
            f"model family {cfg.family!r} has no prefill")

    def fn(params, batch):
        return mod.prefill(params, cfg, batch["tokens"], cache_len,
                           window=window)

    return fn


def make_forward(cfg, *, window: int = 0):
    """Returns fn(params, batch) -> per-request output, for coded serving.

    One batched stateless forward pass: for the linear family the ``(B,)``
    logit vector; for the LM families the ``(B, vocab)`` last-token logits
    of a full-prompt prefill, without its cache (coded serving replicates
    the forward compute, not decode state).
    """
    mod = get_module(cfg)
    if cfg.family == "linear":
        def fn(params, batch):
            return mod.logits(params, cfg, batch["x"])
        return fn

    def fn(params, batch):
        return mod.last_logits(params, cfg, batch["tokens"], window=window)

    return fn
