"""Uniform model interface over the families of the reference's zoo
(``linear``, ``dense``, ``moe``, ``vlm``, ``ssm``, ``hybrid``, ``encdec``);
a family name outside them raises ``NotImplementedError``.

- ``init(cfg, device, generator)``: the parameter dict on ``device``.
- ``make_loss(cfg)``: ``fn(params, batch) -> scalar``; ``batch`` is always a
  dict (x/y for linear, tokens/labels for the LM families, + embeds for
  vlm and encdec).
- ``make_prefill(cfg, cache_len, window)``: ``fn(params, batch) ->
  (last-token logits, cache)`` for the LM families (``cache_len`` counts a
  VLM's patches too; an ``ssm`` state has no positions and takes neither
  ``cache_len`` nor ``window``; an ``encdec`` batch is ``{"embeds": (B, F,
  D)}`` alone, its logits those of token 0 after the frames, and it takes
  neither).
- ``make_forward(cfg, window)``: ``fn(params, batch) -> per-request output``,
  the unit of work coded serving shards across replicas.
- ``make_decode(cfg, window)``: ``fn(params, cache, token) -> (logits,
  cache)``, one decode step against a KV cache, for ``ssm`` the recurrent
  state, for ``hybrid`` the SSM states, conv rings and the shared block's
  KV caches, for ``encdec`` the self-KV ring and the cross-KV (the cache
  is consumed).
- ``cache_spec(cfg, B, S, window)`` / ``init_cache``: the decode state's
  shapes and types, and a zero state (for ``ssm`` the recurrent state of
  ``xlstm.state_spec``, whatever ``S`` and ``window``; for ``hybrid``
  ``mamba_hybrid.state_spec``, whose KV caches take ``S`` and ``window``;
  for ``encdec`` ``S`` counts frames and ``window`` is ignored).
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from . import dense, encdec, linear, mamba_hybrid, moe, vlm, xlstm

_FAMILY = {
    "dense": dense,
    "moe": moe,
    "vlm": vlm,
    "ssm": xlstm,
    "hybrid": mamba_hybrid,
    "encdec": encdec,
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
    ``{"tokens": (B, S)}``, + ``"embeds": (B, P, D)`` for vlm; for encdec
    ``{"embeds": (B, F, D)}`` alone."""
    mod = get_module(cfg)
    if not hasattr(mod, "prefill"):
        raise NotImplementedError(
            f"model family {cfg.family!r} has no prefill")

    def fn(params, batch):
        if cfg.family == "encdec":
            return mod.prefill(params, cfg, batch["embeds"], cache_len)
        if cfg.family == "vlm":
            return mod.prefill(params, cfg, batch["tokens"], cache_len,
                               embeds=batch["embeds"], window=window)
        if cfg.family == "ssm":
            return mod.prefill(params, cfg, batch["tokens"])
        return mod.prefill(params, cfg, batch["tokens"], cache_len,
                           window=window)

    return fn


def make_forward(cfg, *, window: int = 0):
    """Returns fn(params, batch) -> per-request output, for coded serving.

    One batched stateless forward pass: for the linear family the ``(B,)``
    logit vector; for the LM families the ``(B, vocab)`` last-token logits
    of a full-prompt prefill, without its cache (coded serving replicates
    the forward compute, not decode state).  A VLM's prompt is its patches
    and its tokens (the reference's forward prefills into a cache of the
    tokens' length alone, and raises for every VLM).  An encdec request is
    its frames ``{"embeds": (B, F, D)}``: the prefill's logits (token 0
    after the frames), its cache dropped.
    """
    mod = get_module(cfg)
    if cfg.family == "linear":
        def fn(params, batch):
            return mod.logits(params, cfg, batch["x"])
        return fn
    if cfg.family == "vlm":
        def fn(params, batch):
            return mod.last_logits(params, cfg, batch["tokens"],
                                   embeds=batch["embeds"], window=window)
        return fn
    if cfg.family == "ssm":
        def fn(params, batch):
            return mod.last_logits(params, cfg, batch["tokens"])
        return fn
    if cfg.family == "encdec":
        def fn(params, batch):
            embeds = batch["embeds"]
            return mod.prefill(params, cfg, embeds, embeds.shape[1])[0]
        return fn

    def fn(params, batch):
        return mod.last_logits(params, cfg, batch["tokens"], window=window)

    return fn


def _decoder(cfg):
    mod = get_module(cfg)
    if not hasattr(mod, "decode_step"):
        raise NotImplementedError(
            f"model family {cfg.family!r} has no KV-cache decode")
    return mod


def cache_spec(cfg, B: int, S: int, *, window: int = 0) -> dict:
    """``{name: (shape, dtype)}`` of the decode state."""
    mod = _decoder(cfg)
    if cfg.family == "ssm":
        return mod.state_spec(cfg, B)
    if cfg.family == "hybrid":
        return mod.state_spec(cfg, B, S, window=window)
    return mod.cache_spec(cfg, B, S, window=window)


def init_cache(cfg, B: int, S: int, *, window: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """A zero decode state on ``device`` (default: the card; raises when
    there is none)."""
    mod = _decoder(cfg)
    if cfg.family == "ssm":
        return mod.init_state(cfg, B, device=resolve_device(device))
    if cfg.family == "hybrid":
        return mod.init_state(cfg, B, S, window=window,
                              device=resolve_device(device))
    return mod.init_cache(cfg, B, S, window=window,
                          device=resolve_device(device))


def make_decode(cfg, *, window: int = 0):
    """Returns fn(params, cache, token) -> (logits, cache); the input cache
    is consumed (updated in place and returned)."""
    mod = _decoder(cfg)

    def fn(params, cache, token):
        if cfg.family in ("ssm", "encdec"):
            return mod.decode_step(params, cfg, cache, token)
        return mod.decode_step(params, cfg, cache, token, window=window)

    return fn
