"""Dense decoder-only transformer LM (llama/qwen family): GQA + SwiGLU, a
Python loop over the stacked layers, and the full-prompt prefill that coded
serving runs.  KV-cache decoding (``decode_step``, ``cache_spec`` /
``init_cache``) and the training loss are not ported yet."""
from __future__ import annotations

import torch

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


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def forward(params: dict, cfg, tokens: torch.Tensor, *,
            window: int = 0) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V)."""
    x = cm.embed_tokens(params["embed"], tokens, cm.cdtype(cfg))
    pos = _positions(tokens)
    mk = "window" if window else "causal"
    for i in range(cfg.n_layers):
        x = _block(x, cm.layer(params, "layers/", i), cfg, pos, mk, window)
    x = cm.rms_norm(x, params["ln_f"])
    return cm.unembed(x, params["unembed"])


# ---------------------------------------------------------------- serving
def _run_prompt(params: dict, cfg, tokens: torch.Tensor, window: int,
                keep_kv=None) -> torch.Tensor:
    """The prompt through every layer; returns the last-token logits (B, V)
    and hands each layer's (k, v) to ``keep_kv`` when one is given."""
    x = cm.embed_tokens(params["embed"], tokens, cm.cdtype(cfg))
    pos = _positions(tokens)
    mk = "window" if window else "causal"
    for i in range(cfg.n_layers):
        lp = cm.layer(params, "layers/", i)
        y, k, v = cm.self_attention_with_kv(
            lp["attn"], cfg, cm.rms_norm(x, lp["ln1"]), pos, mask_kind=mk,
            window=window)
        x = x + y
        x = x + cm.swiglu(lp["mlp"], cm.rms_norm(x, lp["ln2"]))
        if keep_kv is not None:
            keep_kv(k, v)
    x = cm.rms_norm(x[:, -1:], params["ln_f"])
    return cm.unembed(x, params["unembed"])[:, 0]


def last_logits(params: dict, cfg, tokens: torch.Tensor, *,
                window: int = 0) -> torch.Tensor:
    """``prefill``'s last-token logits (B, V), bit for bit, without building
    the cache: the stateless forward that coded serving replicates."""
    return _run_prompt(params, cfg, tokens, window)


def prefill(params: dict, cfg, tokens: torch.Tensor, cache_len: int, *,
            window: int = 0):
    """Run the prompt, return (last-token logits (B, V), filled cache).

    The cache is ``{"k": (L, B, slots, Hkv, hd), "v": ..., "pos": S}`` with
    ``slots = min(cache_len, window)`` for a sliding window (only the last
    ``window`` positions are kept, rolled into ring order) and
    ``cache_len`` otherwise (zero-padded past the prompt).
    """
    slots = min(cache_len, window) if window else cache_len
    ks, vs = [], []

    def keep_kv(k, v):
        ks.append(cm.pack_cache(k, slots, window))
        vs.append(cm.pack_cache(v, slots, window))

    logits = _run_prompt(params, cfg, tokens, window, keep_kv)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                 device=logits.device)}
    return logits, cache
