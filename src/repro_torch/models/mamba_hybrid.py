"""Zamba2-style hybrid LM (arXiv:2411.15242): a Mamba2 (SSD) backbone with
one *shared* attention block (its own weights, reused) applied after every
group of ``cfg.attn_every`` SSM layers; the last group may be short
(``_group_slices``).

- Mamba2 layer: ``in_proj`` -> [z | x | B | C | dt], a causal depthwise
  conv (k = ``CONV_K``) over [x | B | C], the SSD state-space mixing
  (``ssd_chunked``: quadratic within a chunk of at most ``cfg.ssm_chunk``
  tokens, the ``(B, H, hd, N)`` state carried across chunks in a Python
  loop), gated by ``silu(z)``, ``out_proj``.
- The shared block is ``common``'s attention (the flash kernel above
  ``CHUNK_THRESHOLD`` tokens on the card) and SwiGLU.  Its gradient is the
  sum of its contributions at every application, which autograd forms.
- Training (``loss``) runs each Mamba layer and each application of the
  shared block under ``torch.utils.checkpoint`` (the reference's remat'd
  scan and ``jax.remat``): the backward recomputes one of them at a time.

Decoding carries four parts (``state_spec``, flat keys): ``ssm`` (the SSM
state of every layer), ``conv`` (the last ``CONV_K - 1`` pre-conv rows of
every layer), ``k`` / ``v`` (a KV cache for every application of the
shared block, dense or a ``window`` ring) and ``pos``; ``decode_step``
updates them in place.  Params are the reference's tree flattened by
``repro_torch.convert``: ``mamba/*`` stacked ``(n_layers, ...)``,
``shared_attn/*`` unstacked.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..convert import flatten, unflatten
from . import common as cm
from .xlstm import _chunk_len

CONV_K = 4
_F32 = torch.float32


def _dims(cfg):
    """(d_model, inner width, SSM heads, SSM head size, state size)."""
    D = cfg.d_model
    Di = cfg.ssm_expand * D
    hd = cfg.ssm_head_dim
    return D, Di, Di // hd, hd, cfg.ssm_state


def _group_slices(cfg) -> list[tuple[int, int]]:
    """The layers split into groups of ``attn_every`` (the last group may
    be short); the shared block runs after each."""
    k = cfg.attn_every
    return [(i, min(i + k, cfg.n_layers)) for i in range(0, cfg.n_layers, k)]


# ------------------------------------------------------------------- init
def init(cfg, device: str | torch.device = "cuda",
         generator: torch.Generator | None = None) -> dict:
    """Random parameters on ``device``, keyed and stacked as the reference's
    tree flattened by ``repro_torch.convert``: ``embed``, ``ln_f``,
    ``mamba/*`` with a leading axis of ``n_layers``, ``shared_attn/*``
    (one block) and ``unembed``.  ``A_log`` starts at 0, ``D`` at 1,
    ``dt_bias`` at -2 (all three f32 whatever the config), ``conv_b`` at 0.
    The draws come from ``generator`` (default: a CPU generator seeded
    0)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    D, Di, H, hd, N = _dims(cfg)
    dt, L = cm.pdtype(cfg), (cfg.n_layers,)
    conv_ch = Di + 2 * N

    def w(shape, fan_in):
        return cm.dense_init(gen, L + shape, fan_in, dt, device)

    def full(shape, value, dtype=dt):
        return torch.full(L + shape, value, dtype=dtype, device=device)

    tree = {
        "embed": cm.dense_init(gen, (cfg.vocab, D), D, dt, device),
        "mamba": {
            "ln": full((D,), 1.0),
            "in_proj": w((D, 2 * Di + 2 * N + H), D),
            "conv_w": w((CONV_K, conv_ch), CONV_K),
            "conv_b": full((conv_ch,), 0.0),
            "A_log": full((H,), 0.0, _F32),          # A = -exp(A_log)
            "D": full((H,), 1.0, _F32),              # skip connection
            "dt_bias": full((H,), -2.0, _F32),       # softplus(-2) ~ 0.12
            "out_proj": w((Di, D), Di),
            "norm": full((Di,), 1.0),
        },
        "shared_attn": {
            "ln1": torch.ones((D,), dtype=dt, device=device),
            "attn": cm.attn_params(gen, cfg, dt, device),
            "ln2": torch.ones((D,), dtype=dt, device=device),
            "mlp": cm.mlp_params(gen, cfg, dt, device),
        },
        "ln_f": torch.ones((D,), dtype=dt, device=device),
        "unembed": cm.dense_init(gen, (D, cfg.vocab), D, dt, device),
    }
    return flatten(tree)


# ----------------------------------------------------------- mamba2 (SSD)
def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C) depthwise causal conv, kernel w (K, C): the ordered sum
    of the K shifted products, then the bias (the decode's conv over its
    ring adds the same products in the same order)."""
    T, K = x.shape[1], w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, :T] * w[0].to(x.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _split_proj(lp: dict, cfg, h: torch.Tensor):
    """h: (B, T, D) -> z, xin (B, T, Di), Bmat, Cmat (B, T, N), dt (B, T, H)
    f32, and the pre-conv [x | B | C] rows (B, T, Di + 2N) (the decode's
    conv ring)."""
    _, Di, _, _, N = _dims(cfg)
    proj = torch.matmul(h, lp["in_proj"].to(h.dtype))
    z = proj[..., :Di]
    xBC_pre = proj[..., Di:2 * Di + 2 * N]
    dt_raw = proj[..., 2 * Di + 2 * N:]
    xBC = F.silu(_causal_conv(xBC_pre, lp["conv_w"], lp["conv_b"]))
    xin, Bmat, Cmat = torch.split(xBC, [Di, N, N], dim=-1)
    dt = F.softplus(dt_raw.to(_F32) + lp["dt_bias"].to(_F32))
    return z, xin, Bmat, Cmat, dt, xBC_pre


def ssd_chunked(lp: dict, cfg, xin, Bmat, Cmat, dt):
    """Chunked SSD.  xin: (B, T, Di), Bmat / Cmat (B, T, N), dt (B, T, H)
    f32 -> y (B, T, Di), final state (B, H, hd, N) f32.

    Chunks of the reference's length (``xlstm._chunk_len``).  What a chunk
    computes from its own tokens runs for every chunk at once, laid out
    (B, chunk, H, t, s) so that the products are batched: ``L[t, s] =
    exp(cum_t - cum_s)`` for s <= t (the decay set to -inf above the
    diagonal before the ``exp``, so the kept entries have the reference's
    bits and no inf * 0 reaches the backward), ``y_intra = (CB * L * dt)
    x``, and the chunk's own term of the state at its end (the
    decay-weighted x against B).  Only the carried state is sequential:
    one multiply-add a chunk in a Python loop, then every chunk's ``y_inter``
    (its start state read by C and decayed) in one batched product."""
    _, Di, H, hd, N = _dims(cfg)
    Bsz, T, _ = xin.shape
    cl = _chunk_len(cfg.ssm_chunk, T)
    nc = T // cl
    A = -torch.exp(lp["A_log"])                                   # (H,)
    cum = torch.cumsum((dt * A).reshape(Bsz, nc, cl, H), dim=2)   # in-chunk
    x = xin.reshape(Bsz, nc, cl, H, hd).to(_F32)
    Bm = Bmat.reshape(Bsz, nc, cl, N).to(_F32)
    Cm = Cmat.reshape(Bsz, nc, cl, N).to(_F32)
    cumh = cum.transpose(2, 3)                                    # (B,c,H,cl)
    dth = dt.reshape(Bsz, nc, cl, H).transpose(2, 3)
    xh = x.permute(0, 1, 3, 2, 4)                              # (B,c,H,s,hd)
    # within each chunk
    decay = cumh[..., :, None] - cumh[..., None, :]               # (B,c,H,t,s)
    above = ~cm.causal_mask(cl, xin.device)
    L = torch.exp(decay.masked_fill(above, float("-inf")))
    CB = torch.matmul(Cm, Bm.transpose(2, 3))                     # (B,c,t,s)
    y_intra = torch.matmul(CB[:, :, None] * L * dth[..., None, :], xh)
    end = cumh[..., -1:]                                          # (B,c,H,1)
    xs = xh * (torch.exp(end - cumh) * dth)[..., None]         # (B,c,H,s,hd)
    own = torch.matmul(xs.transpose(3, 4).reshape(Bsz, nc, H * hd, cl), Bm)
    # the state carried across chunks: each chunk's start state
    state = xin.new_zeros((Bsz, H, hd, N), dtype=_F32)
    starts = []
    for own_c, decay_c in zip(torch.unbind(own.reshape(Bsz, nc, H, hd, N), 1),
                              torch.unbind(torch.exp(end)[..., None], 1)):
        starts.append(state)
        state = state * decay_c + own_c
    start = torch.stack(starts, 1).reshape(Bsz, nc, H * hd, N)
    y_inter = torch.matmul(Cm, start.transpose(2, 3)).reshape(
        Bsz, nc, cl, H, hd) * torch.exp(cum)[..., None]
    y = y_intra.transpose(2, 3) + y_inter + x * lp["D"][:, None]
    return y.reshape(Bsz, T, Di).to(xin.dtype), state


def _mamba_layer(lp: dict, cfg, x: torch.Tensor):
    """x: (B, T, D) -> (x + the layer's output, its final SSM state, its
    last ``CONV_K - 1`` pre-conv rows)."""
    h = cm.rms_norm(x, lp["ln"])
    z, xin, Bmat, Cmat, dt, xBC_pre = _split_proj(lp, cfg, h)
    y, state = ssd_chunked(lp, cfg, xin, Bmat, Cmat, dt)
    y = cm.rms_norm(y * F.silu(z), lp["norm"])
    out = x + torch.matmul(y, lp["out_proj"].to(x.dtype))
    return out, state, xBC_pre[:, -(CONV_K - 1):]


def mamba_block(lp: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D) -> x + the Mamba2 layer's output."""
    return _mamba_layer(lp, cfg, x)[0]


def mamba_decode(lp: dict, cfg, x: torch.Tensor, state: torch.Tensor,
                 conv_buf: torch.Tensor):
    """One token.  x: (B, 1, D); state: (B, H, hd, N) f32; conv_buf: (B,
    CONV_K - 1, Di + 2N), the last pre-conv rows.  ``state`` and
    ``conv_buf`` are updated in place (the ring shifts by one row, the new
    row from this step's ``in_proj`` product) and returned with the
    layer's output."""
    _, Di, H, hd, N = _dims(cfg)
    B = x.shape[0]
    h = cm.rms_norm(x, lp["ln"])
    proj = torch.matmul(h, lp["in_proj"].to(h.dtype))
    z = proj[..., :Di]
    seq = torch.cat([conv_buf, proj[:, :, Di:2 * Di + 2 * N]], dim=1)
    dt_raw = proj[:, 0, 2 * Di + 2 * N:]
    w = lp["conv_w"].to(seq.dtype)
    xBC = seq[:, 0] * w[0]
    for i in range(1, CONV_K):
        xBC = xBC + seq[:, i] * w[i]
    xBC = F.silu(xBC + lp["conv_b"].to(seq.dtype))
    conv_buf.copy_(seq[:, 1:])
    xin = xBC[:, :Di].reshape(B, H, hd).to(_F32)
    Bm = xBC[:, Di:Di + N].to(_F32)
    Cm = xBC[:, Di + N:].to(_F32)
    dt = F.softplus(dt_raw.to(_F32) + lp["dt_bias"].to(_F32))      # (B, H)
    dA = torch.exp(dt * -torch.exp(lp["A_log"]))
    # state = dA state + (x dt) B^T, the rank-one update as one product
    state.mul_(dA[..., None, None]).view(B, H * hd, N).baddbmm_(
        (xin * dt[..., None]).reshape(B, H * hd, 1), Bm[:, None])
    y = torch.matmul(state.view(B, H * hd, N), Cm[:, :, None])
    y = y.reshape(B, H, hd) + xin * lp["D"][:, None]
    y = y.reshape(B, 1, Di).to(x.dtype)
    y = cm.rms_norm(y * F.silu(z), lp["norm"])
    return x + torch.matmul(y, lp["out_proj"].to(x.dtype)), state, conv_buf


# ------------------------------------------------------- hybrid structure
def _shared(params: dict) -> dict:
    """The shared block's params as the reference's nested dict."""
    return unflatten({k[len("shared_attn/"):]: v for k, v in params.items()
                      if k.startswith("shared_attn/")})


def _attn_block(sp: dict, cfg, x, pos, mask_kind: str, window: int):
    x = x + cm.self_attention(sp["attn"], cfg, cm.rms_norm(x, sp["ln1"]), pos,
                              mask_kind=mask_kind, window=window)
    return x + cm.swiglu(sp["mlp"], cm.rms_norm(x, sp["ln2"]))


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def forward(params: dict, cfg, tokens: torch.Tensor, *,
            remat: bool = False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V).  ``remat``: each Mamba layer and
    each application of the shared block under ``torch.utils.checkpoint``
    (the same operations on the same inputs in the backward, so the same
    bits)."""
    x = cm.embed_tokens(params["embed"], tokens, cm.cdtype(cfg))
    pos = _positions(x)
    layers = cm.layer_list(params, "mamba/", cfg.n_layers)
    sp = _shared(params)
    for a, b in _group_slices(cfg):
        for lp in layers[a:b]:
            x = checkpoint(mamba_block, lp, cfg, x, use_reentrant=False) \
                if remat else mamba_block(lp, cfg, x)
        args = (sp, cfg, x, pos, "causal", 0)
        x = checkpoint(_attn_block, *args, use_reentrant=False) \
            if remat else _attn_block(*args)
    x = cm.rms_norm(x, params["ln_f"])
    return cm.unembed(x, params["unembed"])


def loss(params: dict, cfg, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B, S), "labels": (B, S)} -> mean xent (f32), each
    Mamba layer and shared-block application recomputed in the
    backward."""
    logits = forward(params, cfg, batch["tokens"], remat=True)
    return cm.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------- serving
def state_spec(cfg, B: int, S: int, *, window: int = 0) -> dict:
    """``{name: (shape, dtype)}`` of the decode state, in the reference
    tree's flattened order: ``conv`` (n_layers, B, CONV_K - 1, Di + 2N),
    ``k`` / ``v`` (n_apps, B, slots, Hkv, hd) with ``slots = min(S,
    window)`` for a window and ``S`` otherwise, ``pos`` 0-d int32, ``ssm``
    (n_layers, B, H, hd, N) f32."""
    _, Di, H, hd, N = _dims(cfg)
    slots = min(S, window) if window else S
    dt = cm.cdtype(cfg)
    kv = ((len(_group_slices(cfg)), B, slots, cfg.n_kv_heads, cfg.head_dim_),
          dt)
    return flatten({
        "ssm": ((cfg.n_layers, B, H, hd, N), _F32),
        "conv": ((cfg.n_layers, B, CONV_K - 1, Di + 2 * N), dt),
        "k": kv, "v": kv, "pos": ((), torch.int32),
    })


def init_state(cfg, B: int, S: int, *, window: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """A zero state of ``state_spec``'s shapes on ``device``."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in state_spec(cfg, B, S,
                                             window=window).items()}


def decode_step(params: dict, cfg, state: dict, token: torch.Tensor, *,
                window: int = 0):
    """One decode step.  token: (B,) int; state from ``init_state`` or
    ``prefill``, ``state["pos"]`` the token's absolute position (a 0-d
    int32 tensor on the device).  Returns (logits (B, V), state): the input
    state is consumed (every layer's SSM state and conv ring and every
    application's k / v are updated in place, the same tensors come back,
    with ``pos`` advanced by one); pass a clone to keep the old one.
    Nothing is read back to the host."""
    with torch.no_grad():
        pos = state["pos"]
        x = cm.embed_tokens(params["embed"], token[:, None], cm.cdtype(cfg))
        layers = cm.layer_list(params, "mamba/", cfg.n_layers)
        sp = _shared(params)
        ssm, conv = torch.unbind(state["ssm"]), torch.unbind(state["conv"])
        ks, vs = torch.unbind(state["k"]), torch.unbind(state["v"])
        for g, (a, b) in enumerate(_group_slices(cfg)):
            for li in range(a, b):
                x, _, _ = mamba_decode(layers[li], cfg, x, ssm[li], conv[li])
            y, _, _ = cm.attention_decode(sp["attn"], cfg,
                                          cm.rms_norm(x, sp["ln1"]), ks[g],
                                          vs[g], pos, window=window)
            x = x + y
            x = x + cm.swiglu(sp["mlp"], cm.rms_norm(x, sp["ln2"]))
        x = cm.rms_norm(x, params["ln_f"])
        logits = cm.unembed(x, params["unembed"])[:, 0]
    return logits, {**state, "pos": pos + 1}


def _run_prompt(params: dict, cfg, tokens: torch.Tensor, window: int,
                keep=None) -> torch.Tensor:
    """The prompt through every group; returns the last position's logits
    (B, V) and hands each layer's (SSM state, conv rows) and each
    application's (k, v) to ``keep(kind, a, b)`` when one is given."""
    x = cm.embed_tokens(params["embed"], tokens, cm.cdtype(cfg))
    pos = _positions(x)
    mk = "window" if window else "causal"
    layers = cm.layer_list(params, "mamba/", cfg.n_layers)
    sp = _shared(params)
    for a, b in _group_slices(cfg):
        for lp in layers[a:b]:
            x, s_fin, conv = _mamba_layer(lp, cfg, x)
            if keep is not None:
                keep("mamba", s_fin, conv)
        y, k, v = cm.self_attention_with_kv(
            sp["attn"], cfg, cm.rms_norm(x, sp["ln1"]), pos, mask_kind=mk,
            window=window)
        x = x + y
        x = x + cm.swiglu(sp["mlp"], cm.rms_norm(x, sp["ln2"]))
        if keep is not None:
            keep("attn", k, v)
    x = cm.rms_norm(x[:, -1:], params["ln_f"])
    return cm.unembed(x, params["unembed"])[:, 0]


def prefill(params: dict, cfg, tokens: torch.Tensor, cache_len: int, *,
            window: int = 0):
    """The chunked-SSD prompt: (last-token logits (B, V), the decode
    state).  Each layer's final SSM state and its last ``CONV_K - 1``
    pre-conv rows (from the same ``in_proj`` product the layer ran); each
    application's k / v packed into ``cache_len`` slots (``min(cache_len,
    window)`` ring slots with a window, its attention then windowed too);
    ``pos = S``.  A prompt shorter than ``CONV_K - 1`` tokens is refused:
    its conv ring would be short of rows, which the decode cannot take (the
    reference builds it, and its own decode raises)."""
    S = tokens.shape[1]
    if S < CONV_K - 1:
        raise ValueError(
            f"a prompt of {S} tokens leaves a conv ring of {S} rows; the "
            f"decode needs CONV_K - 1 = {CONV_K - 1}")
    slots = min(cache_len, window) if window else cache_len
    kept: dict = {"ssm": [], "conv": [], "k": [], "v": []}

    def keep(kind, a, b):
        if kind == "mamba":
            kept["ssm"].append(a)
            kept["conv"].append(b)
        else:
            kept["k"].append(cm.pack_cache(a, slots, window))
            kept["v"].append(cm.pack_cache(b, slots, window))

    logits = _run_prompt(params, cfg, tokens, window, keep)
    state = {k: torch.stack(v) for k, v in kept.items()}
    state["pos"] = torch.tensor(S, dtype=torch.int32, device=logits.device)
    return logits, {k: state[k] for k in state_spec(cfg, 1, 1)}


def last_logits(params: dict, cfg, tokens: torch.Tensor, *,
                window: int = 0) -> torch.Tensor:
    """``prefill``'s last-token logits (B, V), bit for bit, without
    building the state: the stateless forward that coded serving
    replicates."""
    return _run_prompt(params, cfg, tokens, window)
