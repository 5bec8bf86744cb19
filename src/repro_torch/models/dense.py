"""Dense decoder-only transformer LM (llama/qwen family): GQA + SwiGLU, a
Python loop over the stacked layers, the training loss with each layer
recomputed in the backward (the reference's remat'd scan), the full-prompt
prefill that coded serving runs, and KV-cache decoding (dense or
sliding-window ring cache).  The prompt path takes an optional prefix of
embeddings before the tokens (the VLM family's patches)."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..convert import flatten
from . import common as cm


# ------------------------------------------------------------------- init
def init(cfg, device: str | torch.device = "cuda",
         generator: torch.Generator | None = None) -> dict:
    """Random parameters on ``device``, keyed and stacked as the reference's
    tree flattened by ``repro_torch.convert`` (``"layers/attn/wq"`` of shape
    ``(L, D, H, hd)``, ...).  The draws come from ``generator`` (default: a
    CPU generator seeded 0); a generator on the card draws there, which is
    how a full-width model is made without a trip through the host."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    dt, L, D = cm.pdtype(cfg), (cfg.n_layers,), cfg.d_model
    tree = {
        "embed": cm.dense_init(gen, (cfg.vocab, D), D, dt, device),
        "layers": {
            "ln1": torch.ones(L + (D,), dtype=dt, device=device),
            "attn": cm.attn_params(gen, cfg, dt, device, lead=L),
            "ln2": torch.ones(L + (D,), dtype=dt, device=device),
            "mlp": cm.mlp_params(gen, cfg, dt, device, lead=L),
        },
        "ln_f": torch.ones((D,), dtype=dt, device=device),
        "unembed": cm.dense_init(gen, (D, cfg.vocab), D, dt, device),
    }
    return flatten(tree)


# ---------------------------------------------------------------- forward
def _block(x, lp, cfg, pos, mask_kind, window):
    x = x + cm.self_attention(lp["attn"], cfg, cm.rms_norm(x, lp["ln1"]), pos,
                              mask_kind=mask_kind, window=window)
    return x + cm.swiglu(lp["mlp"], cm.rms_norm(x, lp["ln2"]))


def _prompt_rows(params: dict, cfg, tokens: torch.Tensor, embeds=None):
    """The prompt's input rows (B, P + S, D) and their positions: the
    embedded tokens, after ``embeds (B, P, D)`` cast to the compute dtype
    when given (the VLM's patches, ``vlm.py:27-28`` of the reference)."""
    x = cm.embed_tokens(params["embed"], tokens, cm.cdtype(cfg))
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    return x, torch.arange(S, device=x.device)[None].expand(B, S)


def forward(params: dict, cfg, tokens: torch.Tensor, *, window: int = 0,
            remat: bool = False, embeds=None) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V); with ``embeds (B, P, D)`` before
    the tokens, (B, P + S, V).

    ``remat``: run each layer under ``torch.utils.checkpoint`` (the
    reference scans its layers under ``jax.remat``): autograd keeps only
    the layers' inputs, and the backward recomputes one layer at a time
    (the same operations on the same inputs, so the same bits)."""
    x, pos = _prompt_rows(params, cfg, tokens, embeds)
    mk = "window" if window else "causal"
    for lp in cm.layer_list(params, "layers/", cfg.n_layers):
        if remat:
            x = checkpoint(_block, x, lp, cfg, pos, mk, window,
                           use_reentrant=False)
        else:
            x = _block(x, lp, cfg, pos, mk, window)
    x = cm.rms_norm(x, params["ln_f"])
    return cm.unembed(x, params["unembed"])


def loss(params: dict, cfg, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B, S), "labels": (B, S)} -> mean xent (f32), each
    layer recomputed in the backward."""
    logits = forward(params, cfg, batch["tokens"], remat=True)
    return cm.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------- serving
def _mlp(lp: dict, cfg, h: torch.Tensor) -> torch.Tensor:
    """The dense block's feed-forward: SwiGLU."""
    return cm.swiglu(lp["mlp"], h)


def _run_prompt(params: dict, cfg, tokens: torch.Tensor, window: int,
                keep_kv=None, ffn=_mlp, embeds=None) -> torch.Tensor:
    """The prompt (``embeds``, when given, then ``tokens``) through every
    layer; returns the last position's logits (B, V) and hands each layer's
    (k, v) to ``keep_kv`` when one is given.  ``ffn(lp, cfg, h)`` is the
    block's feed-forward (the MoE family passes its expert layer)."""
    x, pos = _prompt_rows(params, cfg, tokens, embeds)
    mk = "window" if window else "causal"
    for lp in cm.layer_list(params, "layers/", cfg.n_layers):
        y, k, v = cm.self_attention_with_kv(
            lp["attn"], cfg, cm.rms_norm(x, lp["ln1"]), pos, mask_kind=mk,
            window=window)
        x = x + y
        x = x + ffn(lp, cfg, cm.rms_norm(x, lp["ln2"]))
        if keep_kv is not None:
            keep_kv(k, v)
    x = cm.rms_norm(x[:, -1:], params["ln_f"])
    return cm.unembed(x, params["unembed"])[:, 0]


def last_logits(params: dict, cfg, tokens: torch.Tensor, *,
                window: int = 0, ffn=_mlp, embeds=None) -> torch.Tensor:
    """``prefill``'s last-token logits (B, V), bit for bit, without building
    the cache: the stateless forward that coded serving replicates."""
    return _run_prompt(params, cfg, tokens, window, ffn=ffn, embeds=embeds)


def cache_spec(cfg, B: int, S: int, *, window: int = 0) -> dict:
    """Shapes and types of the KV cache, ``{"k", "v": ((L, B, slots, Hkv,
    hd), dtype), "pos": ((), int32)}`` (``S`` = max context; a sliding
    window stores ``min(S, window)`` slots)."""
    slots = min(S, window) if window else S
    kv = ((cfg.n_layers, B, slots, cfg.n_kv_heads, cfg.head_dim_),
          cm.cdtype(cfg))
    return {"k": kv, "v": kv, "pos": ((), torch.int32)}


def init_cache(cfg, B: int, S: int, *, window: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """A zero KV cache of ``cache_spec``'s shapes on ``device``."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in cache_spec(cfg, B, S, window=window).items()}


def prefill(params: dict, cfg, tokens: torch.Tensor, cache_len: int, *,
            window: int = 0, ffn=_mlp, embeds=None):
    """Run the prompt, return (last-token logits (B, V), filled cache).

    The cache is ``{"k": (L, B, slots, Hkv, hd), "v": ..., "pos": S}`` with
    ``slots = min(cache_len, window)`` for a sliding window (only the last
    ``window`` positions are kept, rolled into ring order) and
    ``cache_len`` otherwise (zero-padded past the prompt).  ``S`` counts
    the prompt's positions: ``P + S_tokens`` with ``embeds (B, P, D)``.
    ``ffn`` as in ``_run_prompt``.
    """
    slots = min(cache_len, window) if window else cache_len
    ks, vs = [], []

    def keep_kv(k, v):
        ks.append(cm.pack_cache(k, slots, window))
        vs.append(cm.pack_cache(v, slots, window))

    logits = _run_prompt(params, cfg, tokens, window, keep_kv, ffn, embeds)
    S = tokens.shape[1] + (0 if embeds is None else embeds.shape[1])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.tensor(S, dtype=torch.int32, device=logits.device)}
    return logits, cache


def decode_step(params: dict, cfg, cache: dict, token: torch.Tensor, *,
                window: int = 0, ffn=_mlp):
    """One decode step.  token: (B,) int; cache from ``init_cache`` or
    ``prefill``, with ``cache["pos"]`` the absolute position of the token
    being written (a 0-d int32 tensor on the device).

    Returns (logits (B, V), cache).  The input cache is consumed: each
    layer's k/v go into ``cache["k"]`` / ``cache["v"]`` in place and the
    same tensors come back, with ``pos`` advanced by one (the reference
    donates the cache to a functional update; copying it a token would
    double the step's memory traffic).  Pass a clone to keep the old one.
    ``ffn`` as in ``_run_prompt``.
    """
    with torch.no_grad():
        pos = cache["pos"]
        x = cm.embed_tokens(params["embed"], token[:, None], cm.cdtype(cfg))
        layers = cm.layer_list(params, "layers/", cfg.n_layers)
        for lp, kc, vc in zip(layers, torch.unbind(cache["k"]),
                              torch.unbind(cache["v"])):
            y, _, _ = cm.attention_decode(lp["attn"], cfg,
                                          cm.rms_norm(x, lp["ln1"]), kc, vc,
                                          pos, window=window)
            x = x + y
            x = x + ffn(lp, cfg, cm.rms_norm(x, lp["ln2"]))
        x = cm.rms_norm(x, params["ln_f"])
        logits = cm.unembed(x, params["unembed"])[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
