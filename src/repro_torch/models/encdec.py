"""Whisper-style encoder-decoder transformer [arXiv:2212.04356].

As in the reference, the mel-spectrogram and its convolutional feature
extractor are a stub: the model consumes precomputed frame embeddings
``embeds (B, F, d_model)``.

- Encoder: learned positions (``enc_pos``, tiled when ``F`` passes its
  ``n_frontend_tokens`` rows), then bidirectional self-attention
  (``mask_kind="full"``, RoPE on positions ``0..F-1``) and SwiGLU a layer:
  the materialized softmax up to ``CHUNK_THRESHOLD`` frames, the flash
  kernel above it on the card.
- Decoder: learned positions (``dec_pos``, ``cfg.dec_ctx`` of them), causal
  self-attention with RoPE (always materialized: ``S <= dec_ctx``),
  cross-attention over the encoder's output (its K / V projected a layer;
  materialized with an all-true mask up to ``CHUNK_THRESHOLD`` frames, the
  flash kernel with ``mask_kind="full"`` above it) and SwiGLU.
- Training (``loss``) runs every layer of both stacks under
  ``torch.utils.checkpoint`` (the reference's remat'd scans).

Serving: ``prefill`` encodes the frames, projects every decoder layer's
cross K / V once (the fixed part of the cache) and runs one
``decode_step`` on token 0 from an empty self-cache, a ring of ``dec_ctx``
slots.  ``decode_step`` is the reference's own block: its self-attention
projects q, k, v without RoPE and without bias (the training forward
rotates them; ROADMAP C.7 records the gap, kept on both sides), writes
slot ``pos % dec_ctx`` of the ring and adds ``dec_pos[pos % dec_ctx]``.
Params are the reference's tree flattened by ``repro_torch.convert``:
``enc_layers/*`` stacked ``(enc_layers, ...)``, ``dec_layers/*`` stacked
``(n_layers, ...)``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..convert import flatten
from . import common as cm


# ------------------------------------------------------------------- init
def init(cfg, device: str | torch.device = "cuda",
         generator: torch.Generator | None = None) -> dict:
    """Random parameters on ``device``, keyed and stacked as the reference's
    tree flattened by ``repro_torch.convert`` (``"dec_layers/xattn/wk"`` of
    shape ``(n_layers, D, Hkv, hd)``, ``"enc_pos"`` ``(n_frontend_tokens,
    D)``, ...); norms start at 1.  The draws come from ``generator``
    (default: a CPU generator seeded 0); on the ``meta`` device only shapes
    and types are made."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    dt, D = cm.pdtype(cfg), cfg.d_model
    Le, Ld = (cfg.enc_layers,), (cfg.n_layers,)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    tree = {
        "enc_pos": cm.dense_init(gen, (cfg.n_frontend_tokens, D), D, dt,
                                 device),
        "enc_layers": {
            "ln1": ones(Le + (D,)),
            "attn": cm.attn_params(gen, cfg, dt, device, lead=Le),
            "ln2": ones(Le + (D,)),
            "mlp": cm.mlp_params(gen, cfg, dt, device, lead=Le),
        },
        "enc_ln_f": ones((D,)),
        "embed": cm.dense_init(gen, (cfg.vocab, D), D, dt, device),
        "dec_pos": cm.dense_init(gen, (cfg.dec_ctx, D), D, dt, device),
        "dec_layers": {
            "ln1": ones(Ld + (D,)),
            "attn": cm.attn_params(gen, cfg, dt, device, lead=Ld),
            "lnx": ones(Ld + (D,)),
            "xattn": cm.attn_params(gen, cfg, dt, device, lead=Ld),
            "ln2": ones(Ld + (D,)),
            "mlp": cm.mlp_params(gen, cfg, dt, device, lead=Ld),
        },
        "ln_f": ones((D,)),
        "unembed": cm.dense_init(gen, (D, cfg.vocab), D, dt, device),
    }
    return flatten(tree)


# ---------------------------------------------------------------- forward
def _xattend(p: dict, cfg, x: torch.Tensor, enc_k: torch.Tensor,
             enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention: queries from x (B, S, D), the encoder's K / V
    (B, F, Hkv, hd) precomputed.  ``CHUNK_THRESHOLD`` is read at each call
    (the reference's module constant)."""
    q = cm._proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    S, F = x.shape[1], enc_k.shape[1]
    if F <= cm.CHUNK_THRESHOLD:
        mask = torch.ones((S, F), dtype=torch.bool, device=x.device)
        out = cm.gqa_scores_attend(q, enc_k, enc_v, mask, cfg.q_per_kv)
    else:
        out = cm.online_attention(q, enc_k, enc_v, cfg.q_per_kv,
                                  mask_kind="full")
    return cm._out_proj(out, p["wo"])


def _enc_kv(p: dict, x: torch.Tensor):
    """The encoder output's K and V for one decoder layer (B, F, Hkv, hd)."""
    k, v = cm._proj(x, p["wk"]), cm._proj(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return k, v


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _enc_block(h, lp, cfg, pos):
    h = h + cm.self_attention(lp["attn"], cfg, cm.rms_norm(h, lp["ln1"]),
                              pos, mask_kind="full")
    return h + cm.swiglu(lp["mlp"], cm.rms_norm(h, lp["ln2"]))


def encode(params: dict, cfg, embeds: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """embeds (B, F, D) stub frame embeddings -> encoder output (B, F, D).
    ``remat``: each layer under ``torch.utils.checkpoint``."""
    B, F = embeds.shape[:2]
    x = embeds.to(cm.cdtype(cfg))
    # learned positions, tiled past the n_frontend_tokens rows (30 s)
    pos_emb = params["enc_pos"].to(x.dtype)
    reps = -(-F // pos_emb.shape[0])
    x = x + pos_emb.repeat(reps, 1)[:F]
    pos = _positions(B, F, x.device)
    for lp in cm.layer_list(params, "enc_layers/", cfg.enc_layers):
        x = checkpoint(_enc_block, x, lp, cfg, pos, use_reentrant=False) \
            if remat else _enc_block(x, lp, cfg, pos)
    return cm.rms_norm(x, params["enc_ln_f"])


def _dec_block(h, lp, cfg, pos, mask, enc_out):
    h = h + cm.attention(lp["attn"], cfg, cm.rms_norm(h, lp["ln1"]), pos,
                         mask)
    hx = cm.rms_norm(h, lp["lnx"])
    ek, ev = _enc_kv(lp["xattn"], enc_out)
    h = h + _xattend(lp["xattn"], cfg, hx, ek, ev)
    return h + cm.swiglu(lp["mlp"], cm.rms_norm(h, lp["ln2"]))


def decode_train(params: dict, cfg, enc_out: torch.Tensor,
                 tokens: torch.Tensor, *, remat: bool = False
                 ) -> torch.Tensor:
    """tokens (B, S <= dec_ctx) -> logits (B, S, V), teacher-forced over
    the encoder's output.  ``remat`` as in ``encode``."""
    B, S = tokens.shape
    x = cm.embed_tokens(params["embed"], tokens, cm.cdtype(cfg))
    x = x + params["dec_pos"].to(x.dtype)[:S]
    pos = _positions(B, S, x.device)
    mask = cm.causal_mask(S, x.device)
    for lp in cm.layer_list(params, "dec_layers/", cfg.n_layers):
        x = checkpoint(_dec_block, x, lp, cfg, pos, mask, enc_out,
                       use_reentrant=False) \
            if remat else _dec_block(x, lp, cfg, pos, mask, enc_out)
    x = cm.rms_norm(x, params["ln_f"])
    return cm.unembed(x, params["unembed"])


def loss(params: dict, cfg, batch: dict) -> torch.Tensor:
    """batch: {"embeds": (B, F, D), "tokens": (B, S), "labels": (B, S)} ->
    mean xent (f32), every layer of both stacks recomputed in the
    backward."""
    enc_out = encode(params, cfg, batch["embeds"], remat=True)
    logits = decode_train(params, cfg, enc_out, batch["tokens"], remat=True)
    return cm.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------- serving
def cache_spec(cfg, B: int, S: int, **_) -> dict:
    """``{name: (shape, dtype)}`` of the decode state: the self-KV ring
    ``k`` / ``v`` (n_layers, B, dec_ctx, Hkv, hd), the cross-KV ``xk`` /
    ``xv`` (n_layers, B, S, Hkv, hd) over ``S`` frames and ``pos`` (0-d
    int32).  A ``window`` is accepted and ignored, as in the reference."""
    dt = cm.cdtype(cfg)
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    kv = ((L, B, cfg.dec_ctx, Hkv, hd), dt)
    xkv = ((L, B, S, Hkv, hd), dt)
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv, "pos": ((), torch.int32)}


def init_cache(cfg, B: int, S: int, *, device: str | torch.device = "cuda",
               **_) -> dict:
    """A zero decode state of ``cache_spec``'s shapes on ``device``."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in cache_spec(cfg, B, S).items()}


def prefill(params: dict, cfg, embeds: torch.Tensor, cache_len: int = 0,
            **_):
    """Encode the frames (B, F, D), project every decoder layer's cross
    K / V, then one ``decode_step`` on token 0 from an empty self-cache:
    (its logits (B, V), the cache with ``pos = 1``).  ``cache_len`` is
    ignored, as in the reference (the self-cache is a ring of
    ``dec_ctx``, the cross-KV spans the frames)."""
    B = embeds.shape[0]
    enc_out = encode(params, cfg, embeds)
    xks, xvs = [], []
    for lp in cm.layer_list(params, "dec_layers/", cfg.n_layers):
        k, v = _enc_kv(lp["xattn"], enc_out)
        xks.append(k)
        xvs.append(v)
    cache = init_cache(cfg, B, 0, device=embeds.device)
    cache.update(xk=torch.stack(xks), xv=torch.stack(xvs))
    sot = torch.zeros((B,), dtype=torch.int32, device=embeds.device)
    return decode_step(params, cfg, cache, sot)


def decode_step(params: dict, cfg, cache: dict, token: torch.Tensor, **_):
    """One decoder token (B,) against the self-KV ring and the fixed
    cross-KV; ``cache["pos"]`` is the token's position (a 0-d int32 tensor
    on the device).  The reference's block: self-attention without RoPE or
    bias into slot ``pos % dec_ctx`` (every slot valid once ``pos``
    reaches ``dec_ctx``), cross-attention (the flash kernel above
    ``CHUNK_THRESHOLD`` frames on the card), ``dec_pos[pos % dec_ctx]``.

    Returns (logits (B, V), cache).  The cache is consumed: each layer's
    k / v go into ``cache["k"]`` / ``cache["v"]`` in place and the same
    tensors come back with ``pos`` advanced by one; nothing is read back
    to the host."""
    with torch.no_grad():
        B, ctx = token.shape[0], cfg.dec_ctx
        pos = cache["pos"]
        slot = pos % ctx
        slot1 = slot.reshape(1).long()
        x = cm.embed_tokens(params["embed"], token[:, None], cm.cdtype(cfg))
        x = x + torch.index_select(params["dec_pos"], 0, slot1).to(
            x.dtype)[None]
        j = torch.arange(ctx, device=x.device)
        valid = (j <= slot) | (pos >= ctx)
        mask = valid[None, None, :].expand(B, 1, ctx)
        layers = cm.layer_list(params, "dec_layers/", cfg.n_layers)
        for lp, kc, vc, xk, xv in zip(
                layers, torch.unbind(cache["k"]), torch.unbind(cache["v"]),
                torch.unbind(cache["xk"]), torch.unbind(cache["xv"])):
            h = cm.rms_norm(x, lp["ln1"])
            pa = lp["attn"]
            q, k, v = cm._proj(h, pa["wq"]), cm._proj(h, pa["wk"]), \
                cm._proj(h, pa["wv"])
            kc.index_copy_(1, slot1, k.to(kc.dtype))
            vc.index_copy_(1, slot1, v.to(vc.dtype))
            out = cm.gqa_scores_attend(q, kc, vc, mask, cfg.q_per_kv)
            x = x + cm._out_proj(out, pa["wo"])
            x = x + _xattend(lp["xattn"], cfg, cm.rms_norm(x, lp["lnx"]), xk,
                             xv)
            x = x + cm.swiglu(lp["mlp"], cm.rms_norm(x, lp["ln2"]))
        x = cm.rms_norm(x, params["ln_f"])
        logits = cm.unembed(x, params["unembed"])[:, 0]
    return logits, {**cache, "pos": pos + 1}
