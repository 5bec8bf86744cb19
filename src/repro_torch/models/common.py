"""Shared model components of the dense LM: norms, RoPE, GQA attention (the
materialized softmax for short sequences, the online softmax for long ones),
SwiGLU MLP, the prefill cache layout, one-token decoding against a KV cache,
and the cross-entropy loss.

Conventions, as in the reference (``repro/models/common.py``):

- Params are flat dicts of tensors keyed ``"a/b/c"`` (the reference's nested
  dicts, flattened by ``repro_torch.convert``); layer stacks keep a leading
  ``L`` axis, which a Python loop walks where the reference scans.
- ``cfg.compute_dtype`` is used for activations; params stay in
  ``cfg.param_dtype``.  Logits are float32 for f32 configs.
- Every public function takes and returns the ``(B, S, H, hd)`` layout.
- The large products (projections, MLP, unembedding, the materialized
  scores) are ``torch.matmul`` / ``einsum``, as the reference leaves them to
  XLA; ``online_attention`` on a CUDA tensor launches the hand-written flash
  attention kernel (``repro_torch.kernels.flash_attn``), on a CPU tensor it
  runs that kernel's plain version, the reference's chunked loop.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flash_attn import CHUNK_KV, CHUNK_Q, flash_attention_gqa

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg) -> torch.dtype:
    """The activation type of ``cfg``."""
    return _DTYPES[cfg.compute_dtype]


def pdtype(cfg) -> torch.dtype:
    """The parameter type of ``cfg``."""
    return _DTYPES[cfg.param_dtype]


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, gain: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, computed in f32, returned in x's type."""
    x32 = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gain.to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope_freqs(hd: int, theta: float) -> np.ndarray:
    """The ``hd / 2`` rotation frequencies, in float64 on the host."""
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


_FREQS: dict = {}   # (hd, theta, device) -> rope_freqs as f32 on the device


def _device_freqs(hd: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` in f32 on ``device``, copied there once: a copy from
    the host a call would wait for the device, a sync a layer and token."""
    key = (hd, theta, device)
    if key not in _FREQS:
        _FREQS[key] = torch.as_tensor(rope_freqs(hd, theta),
                                      dtype=torch.float32, device=device)
    return _FREQS[key]


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), pos: (..., S) int -> rotated x (same type).

    The reference's pairing: the first half of ``hd`` with the second half
    (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = _device_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = pos.to(torch.float32)[..., None] * freqs               # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- init
def dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
               device) -> torch.Tensor:
    """Normal draws scaled by ``1/sqrt(in_axis_size)``, made on the
    generator's device and moved to ``device``.  On the ``meta`` device only
    the shape and type are made: no draw, no memory."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * (1.0 / np.sqrt(in_axis_size))).to(device=device, dtype=dtype)


def attn_params(gen: torch.Generator, cfg, dtype, device,
                lead: tuple = ()) -> dict:
    """Attention weights, each with the leading dims ``lead`` (the layer
    stack), keyed as in the reference."""
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": dense_init(gen, lead + (D, H, hd), D, dtype, device),
        "wk": dense_init(gen, lead + (D, Hkv, hd), D, dtype, device),
        "wv": dense_init(gen, lead + (D, Hkv, hd), D, dtype, device),
        "wo": dense_init(gen, lead + (H, hd, D), H * hd, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (Hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (Hkv, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
    return p


def mlp_params(gen: torch.Generator, cfg, dtype, device, lead: tuple = (),
               d_ff: int | None = None) -> dict:
    """SwiGLU weights with the leading dims ``lead``."""
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, lead + (D, Fd), D, dtype, device),
        "w_up": dense_init(gen, lead + (D, Fd), D, dtype, device),
        "w_down": dense_init(gen, lead + (Fd, D), Fd, dtype, device),
    }


# -------------------------------------------------------------- attention
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,d...->bs...") as one matmul."""
    return torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


def qkv_project(p: dict, cfg, x: torch.Tensor, pos: torch.Tensor):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,Hkv,hd) with bias/qk_norm/rope."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def gqa_scores_attend(q, k, v, mask, q_per_kv: int) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd), mask: (B,Sq,Sk) or (Sq,Sk) bool.

    The materialized softmax: the whole ``(Sq, Sk)`` score matrix in f32."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, q_per_kv, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k).to(torch.float32)
    logits = logits / np.sqrt(hd)
    if mask.ndim == 2:
        mask = mask[None]
    logits = torch.where(mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(B, Sq, H, hd)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    B, S, H, hd = out.shape
    return torch.matmul(out.reshape(B, S, H * hd),
                        wo.to(out.dtype).reshape(H * hd, -1))


def attention(p: dict, cfg, x: torch.Tensor, pos: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Self-attention with an explicit mask, always the materialized
    softmax (the reference's ``attention``).  x: (B, S, D)."""
    q, k, v = qkv_project(p, cfg, x, pos)
    return _out_proj(gqa_scores_attend(q, k, v, mask, cfg.q_per_kv), p["wo"])


# ----------------------------------------------- chunked (online-softmax)
CHUNK_THRESHOLD = 2048  # switch to the online softmax above this length


def online_attention(q, k, v, q_per_kv: int, *, mask_kind: str = "causal",
                     window: int = 0, chunk_q: int = CHUNK_Q,
                     chunk_kv: int = CHUNK_KV, kv_pos0: int = 0):
    """Flash-style attention: never materializes ``(Sq, Sk)``.

    q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd).  mask_kind: "causal" | "full"
    | "window" (causal with a back-window).  Query positions are
    ``kv_pos0 + arange(Sq)`` relative to kv positions ``arange(Sk)``.  On a
    CUDA tensor this is the flash attention kernel (its own tiles; the
    chunks apply to the CPU's plain version only).
    """
    return flash_attention_gqa(q, k, v, q_per_kv, mask_kind=mask_kind,
                               window=window, kv_pos0=kv_pos0,
                               chunk_q=chunk_q, chunk_kv=chunk_kv)


def causal_mask(S: int, device=None) -> torch.Tensor:
    """(S, S) bool: key j visible from query i iff j <= i."""
    return torch.tril(torch.ones((S, S), dtype=torch.bool, device=device))


def sliding_causal_mask(S: int, window: int, device=None) -> torch.Tensor:
    """(S, S) bool: causal, and j > i - window."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    return (j <= i) & (j > i - window)


def _attend(q, k, v, cfg, mask_kind: str, window: int) -> torch.Tensor:
    """The reference's branch: the materialized softmax up to
    ``CHUNK_THRESHOLD`` tokens, the online softmax above."""
    S = q.shape[1]
    if S <= CHUNK_THRESHOLD:
        if mask_kind == "causal":
            mask = causal_mask(S, q.device)
        elif mask_kind == "window":
            mask = sliding_causal_mask(S, window, q.device)
        else:
            mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
        return gqa_scores_attend(q, k, v, mask, cfg.q_per_kv)
    return online_attention(q, k, v, cfg.q_per_kv, mask_kind=mask_kind,
                            window=window)


def self_attention(p: dict, cfg, x: torch.Tensor, pos: torch.Tensor, *,
                   mask_kind: str = "causal", window: int = 0) -> torch.Tensor:
    """Mask-kind self-attention that picks the materialized path for short
    sequences and the online-softmax path for long ones."""
    q, k, v = qkv_project(p, cfg, x, pos)
    return _out_proj(_attend(q, k, v, cfg, mask_kind, window), p["wo"])


def self_attention_with_kv(p: dict, cfg, x: torch.Tensor, pos: torch.Tensor,
                           *, mask_kind: str = "causal", window: int = 0):
    """Like ``self_attention`` but also returns (k, v) for prefill caching."""
    q, k, v = qkv_project(p, cfg, x, pos)
    y = _out_proj(_attend(q, k, v, cfg, mask_kind, window), p["wo"])
    return y, k, v


# ------------------------------------------------------- KV-cache decoding
def attention_decode(p: dict, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0):
    """One-token decode.  x: (B, 1, D); k/v_cache: (B, S, Hkv, hd); pos: the
    0-d int tensor of the token's absolute position, on the device.

    This step's k/v are written into the caches in place (slot ``pos`` for a
    dense cache, ``pos % S`` for a ring of ``window`` slots) and the caches
    are returned: the reference donates them to a functional update, here
    they are consumed.  The slot is a device index, so nothing waits for the
    host.  The attention is the materialized softmax over the cache's
    ``S`` slots, never the flash kernel: a single query row.
    """
    B = x.shape[0]
    q, k, v = qkv_project(p, cfg, x, pos.expand(B, 1))
    S = k_cache.shape[1]
    slot = (pos % S if window else pos).reshape(1).long()
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    j = torch.arange(S, device=x.device)
    if window:
        valid = (j <= pos % S) | (pos >= S)          # ring buffer fullness
    else:
        valid = j <= pos
    mask = valid[None, None, :].expand(B, 1, S)
    out = gqa_scores_attend(q, k_cache, v_cache, mask, cfg.q_per_kv)
    return _out_proj(out, p["wo"]), k_cache, v_cache


def pack_cache(k: torch.Tensor, slots: int, window: int) -> torch.Tensor:
    """Place prefill-time keys/values (B, S, H, hd), ordered by position,
    into a cache of ``slots`` entries so that decoding's slot arithmetic
    (``pos`` for dense, ``pos % slots`` for ring) lines up.

    - dense (window == 0): position p lives at slot p; requires S <= slots,
      padded with zeros at the end.
    - ring (window > 0, slots == window): position p lives at slot
      p % slots; keep the last ``slots`` positions and roll them into place.
    """
    S = k.shape[1]
    if S <= slots:
        return F.pad(k, (0, 0) * (k.ndim - 2) + (0, slots - S))
    if not window:
        raise ValueError(f"dense cache too small: S={S} > slots={slots}")
    return torch.roll(k[:, S - slots:], S % slots, dims=1)


# ------------------------------------------------------------------- MLP
def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * x W_up) W_down``."""
    g = torch.matmul(x, p["w_gate"].to(x.dtype))
    u = torch.matmul(x, p["w_up"].to(x.dtype))
    return torch.matmul(F.silu(g) * u, p["w_down"].to(x.dtype))


# -------------------------------------------------- embedding / unembedding
def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    """Rows of ``emb`` for ``tokens`` (any int type), in ``dtype``."""
    return emb.to(dtype)[tokens.long()]


def unembed(x: torch.Tensor, emb_out: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) logits."""
    return torch.matmul(x, emb_out.to(x.dtype))


def layer_list(stacked: dict, prefix: str, n: int) -> list[dict]:
    """The ``n`` layers of the stacked leaves under ``prefix``, each a
    nested dict keyed like the reference's per-layer params (``{"attn":
    {"wq": ...}}``), from one ``unbind`` a leaf: under autograd the layers'
    gradients are stacked once, where a select a layer would give each
    layer a zero-filled gradient the size of the whole stack."""
    out: list[dict] = [{} for _ in range(n)]
    for key, v in stacked.items():
        if not key.startswith(prefix):
            continue
        *parents, last = key[len(prefix):].split("/")
        for node, vi in zip(out, torch.unbind(v)):
            for part in parents:
                node = node.setdefault(part, {})
            node[last] = vi
    return out


# ------------------------------------------------------------------ loss
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy in float32.  logits: (..., V); with a
    ``mask`` the mean over its weight (at least 1)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
