"""InternVL2-style VLM: the language backbone (InternLM2, a llama-family GQA
decoder) consuming stub vision embeddings [arXiv:2404.16821].

As in the reference, the ViT and its MLP projector are a stub: ``embeds``
(B, P, d_model) are precomputed patch embeddings, placed before the token
embeddings (``dense``'s prompt path takes them as a prefix).  The loss is
taken on the text positions only.  Serving prefills patches and text into
a standard KV cache; decoding is the dense LM's.
"""
from __future__ import annotations

import torch

from . import common as cm
from . import dense

init = dense.init          # the dense backbone's parameters
cache_spec = dense.cache_spec
init_cache = dense.init_cache
decode_step = dense.decode_step


def forward(params: dict, cfg, tokens: torch.Tensor, embeds: torch.Tensor,
            *, window: int = 0, remat: bool = False) -> torch.Tensor:
    """tokens: (B, S_txt); embeds: (B, P, D) -> logits (B, P + S_txt, V).
    ``remat`` as in ``dense.forward``."""
    return dense.forward(params, cfg, tokens, window=window, remat=remat,
                         embeds=embeds)


def loss(params: dict, cfg, batch: dict) -> torch.Tensor:
    """batch: {"embeds": (B, P, D), "tokens": (B, S), "labels": (B, S)} ->
    mean xent (f32) on the text positions, each layer recomputed in the
    backward."""
    logits = forward(params, cfg, batch["tokens"], batch["embeds"],
                     remat=True)
    P = batch["embeds"].shape[1]
    return cm.softmax_xent(logits[:, P:], batch["labels"])


def prefill(params: dict, cfg, tokens: torch.Tensor, cache_len: int, *,
            embeds: torch.Tensor, window: int = 0):
    """Prefill patches and text into the KV cache: (last-token logits (B,
    V), cache with ``pos = P + S_txt``); ``cache_len`` counts both."""
    return dense.prefill(params, cfg, tokens, cache_len, window=window,
                         embeds=embeds)


def last_logits(params: dict, cfg, tokens: torch.Tensor, *,
                embeds: torch.Tensor, window: int = 0) -> torch.Tensor:
    """``prefill``'s last-token logits (B, V), bit for bit, without the
    cache: the stateless forward that coded serving replicates."""
    return dense.last_logits(params, cfg, tokens, window=window,
                             embeds=embeds)
