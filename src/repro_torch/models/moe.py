"""Mixture-of-Experts decoder LM (olmoe / grok family).

Routing: a top-k softmax router in f32 with capacity-based dispatch (Switch
style).  Picks that overflow an expert's capacity ``C = ceil(T*K/E *
capacity_factor)``, counted in token order over the whole forward's ``T``
tokens, are dropped; a load-balance auxiliary loss (Shazeer) keeps the
router spread.  Expert weights carry a leading ``E`` axis.

As in the reference, a forward depends on its batch: the capacity counts
every token of the call, so a prompt's logits depend on the prompts that
share the forward, and a decode step (``T = B``) runs at a capacity of one
or two slots an expert.  Every expert runs on its ``C`` slots, empty ones
too.

Two dispatches, chosen by the module constant ``DISPATCH`` at call time:

- ``"scatter"`` (the default): each kept pick's row is written to its own
  ``(expert, slot)`` row of an ``(E, C + 1, D)`` buffer (dropped picks go
  to the pad row ``C``, which is sliced off), the experts run as batched
  products over ``E``, and each pick reads its row back.  Token ``t`` owns
  the picks ``t*K ... t*K + K - 1``, so the gather of the token rows is an
  ``expand`` and the combine a sum over ``K``: both are fixed-order sums,
  forward and backward, and no row takes two contributions but the pad row
  (a pick has one row, a kept row one pick), so a subset gradient repeats
  its bits on the card.
- ``"einsum"``: the chunked one-hot dispatch (Switch/GShard style): tokens
  go in chunks of ``TOKEN_CHUNK``, each with its own capacity, and every
  chunk is recomputed in the backward (the reference remats it).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..convert import flatten
from . import common as cm
from . import dense

AUX_LOSS_WEIGHT = 0.01

# the dispatch: "scatter" (capacity dispatch by rows) or "einsum" (chunked
# one-hot products), read at each call
DISPATCH = "scatter"
TOKEN_CHUNK = 2048

_F32 = torch.float32


# ------------------------------------------------------------------- init
def init(cfg, device: str | torch.device = "cuda",
         generator: torch.Generator | None = None) -> dict:
    """Random parameters on ``device``, keyed and stacked as the reference's
    tree flattened by ``repro_torch.convert``: the dense keys but the MLP,
    plus ``"layers/router"`` ``(L, D, E)`` and ``"layers/moe/w_gate"``,
    ``"w_up"`` ``(L, E, D, F)`` and ``"w_down"`` ``(L, E, F, D)``.  The draws
    come from ``generator`` (default: a CPU generator seeded 0)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    dt, L = cm.pdtype(cfg), (cfg.n_layers,)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    tree = {
        "embed": cm.dense_init(gen, (cfg.vocab, D), D, dt, device),
        "layers": {
            "ln1": torch.ones(L + (D,), dtype=dt, device=device),
            "attn": cm.attn_params(gen, cfg, dt, device, lead=L),
            "ln2": torch.ones(L + (D,), dtype=dt, device=device),
            "router": cm.dense_init(gen, L + (D, E), D, dt, device),
            "moe": {
                "w_gate": cm.dense_init(gen, L + (E, D, Fd), D, dt, device),
                "w_up": cm.dense_init(gen, L + (E, D, Fd), D, dt, device),
                "w_down": cm.dense_init(gen, L + (E, Fd, D), Fd, dt, device),
            },
        },
        "ln_f": torch.ones((D,), dtype=dt, device=device),
        "unembed": cm.dense_init(gen, (D, cfg.vocab), D, dt, device),
    }
    return flatten(tree)


# ---------------------------------------------------------------- routing
def capacity(cfg, T: int) -> int:
    """Slots an expert for ``T`` tokens: ``ceil(T*K/E * capacity_factor)``
    in Python floats, in the reference's order."""
    return int(math.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def route(router: torch.Tensor, top_k: int, xt: torch.Tensor):
    """One layer's router ``(D, E)`` on ``xt (T, D)``, in f32: ``(probs (T,
    E), gate (T, K), eidx (T, K))``, the top-k gates renormalised to sum to
    one (with a 1e-9 floor), in descending order as ``top_k`` gives them."""
    logits = torch.matmul(xt.to(_F32), router.to(_F32))
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, top_k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, eidx


class Dispatch(NamedTuple):
    """Where each of the ``T*K`` picks (token-major) goes: its slot in its
    expert (0-based, counted in token order), whether it fits the capacity,
    and its row ``expert * (C + 1) + slot`` of the dispatch buffer (the pad
    row ``C`` for a dropped pick); ``load`` counts the picks of each expert,
    kept or not."""

    slot: torch.Tensor         # (T*K,) int64
    keep: torch.Tensor         # (T*K,) bool
    row: torch.Tensor          # (T*K,) int64
    load: torch.Tensor         # (E,) int64


def dispatch(eidx: torch.Tensor, n_experts: int, C: int) -> Dispatch:
    """The scatter dispatch's slots for ``eidx (T, K)`` at capacity ``C``:
    a pick's slot is the number of earlier picks of its expert.  The
    reference counts them with a running sum down a ``(T*K, E)`` one-hot;
    here a pick's rank in a stable sort by expert, less the first rank of
    its expert, gives the same numbers in O(T*K) and with no host sync."""
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    rank = torch.argsort(order)                    # the inverse permutation
    by_expert = flat_e[order]
    experts = torch.arange(n_experts, device=flat_e.device)
    first = torch.searchsorted(by_expert, experts)
    load = torch.searchsorted(by_expert, experts, right=True) - first
    slot = rank - first[flat_e]
    keep = slot < C
    slot_c = torch.where(keep, slot, C)
    return Dispatch(slot=slot, keep=keep, row=flat_e * (C + 1) + slot_c,
                    load=load)


def _experts(buf: torch.Tensor, w: dict) -> torch.Tensor:
    """SwiGLU of every expert on its slots: ``buf (E, C, D) -> (E, C, D)``,
    batched products over ``E``."""
    dt = buf.dtype
    g = torch.bmm(buf, w["w_gate"].to(dt))
    u = torch.bmm(buf, w["w_up"].to(dt))
    return torch.bmm(F.silu(g) * u, w["w_down"].to(dt))


# ------------------------------------------------------------------ MoE op
def moe_ffn(lp: dict, cfg, x: torch.Tensor):
    """The dispatch switch (see ``DISPATCH``): ``x (B, S, D) -> (y, aux)``."""
    if DISPATCH == "einsum":
        return moe_ffn_einsum(lp, cfg, x)
    return moe_ffn_scatter(lp, cfg, x)


def moe_ffn_scatter(lp: dict, cfg, x: torch.Tensor):
    """x: (B, S, D) -> (y: (B, S, D), aux_loss: f32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    probs, gate, eidx = route(lp["router"], K, xt)
    C = capacity(cfg, T)
    r = dispatch(eidx, E, C)

    # load-balance aux loss (Shazeer): E * sum_e f_e * p_e
    me = probs.mean(0)
    ce = r.load.to(_F32) / (T * K)
    aux = E * torch.sum(me * ce)

    rows = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf = x.new_zeros((E * (C + 1), D)).index_put((r.row,), rows)
    out = _experts(buf.view(E, C + 1, D)[:, :C], lp["moe"])
    out = F.pad(out, (0, 0, 0, 1))                     # the pad row reads 0
    picked = out.reshape(E * (C + 1), D)[r.row]
    picked = picked * (r.keep.to(x.dtype)
                       * gate.reshape(-1).to(x.dtype))[:, None]
    y = picked.view(T, K, D).sum(1)
    return y.reshape(B, S, D), aux


def einsum_slots(onehot_e: torch.Tensor, Cc: int):
    """The einsum dispatch's slots: ``onehot_e (Tc, K, E)`` f32 picks ->
    ``(pos (Tc, K) f32, keep (Tc, K) bool)``, a pick's 0-based position
    among its expert's picks in the chunk, kept below ``Cc``."""
    Tc, K, E = onehot_e.shape
    flat = onehot_e.reshape(Tc * K, E)
    pos = torch.cumsum(flat, dim=0) * flat
    pos = (pos.sum(-1) - 1.0).reshape(Tc, K)
    return pos, pos < Cc


def _einsum_chunk(xc, router, w_gate, w_up, w_down, E, K, Cc):
    """One token chunk of the einsum dispatch: ``(probs summed over the
    chunk (E,), picks an expert (E,), y (Tc, D))``."""
    probs, gate, eidx = route(router, K, xc)
    onehot_e = F.one_hot(eidx, E).to(_F32)                     # (Tc, K, E)
    pos, keep = einsum_slots(onehot_e, Cc)
    onehot_c = (pos[..., None] == torch.arange(Cc, dtype=_F32,
                                               device=xc.device)).to(_F32)
    onehot_c = onehot_c * keep[..., None].to(_F32)             # (Tc, K, Cc)
    disp = torch.einsum("tke,tkc->tec", onehot_e, onehot_c)
    comb = torch.einsum("tke,tkc,tk->tec", onehot_e, onehot_c, gate)
    buf = torch.einsum("tec,td->ecd", disp.to(xc.dtype), xc)
    out = _experts(buf, {"w_gate": w_gate, "w_up": w_up, "w_down": w_down})
    yc = torch.einsum("tec,ecd->td", comb.to(xc.dtype), out)
    return probs.sum(0), onehot_e.sum((0, 1)), yc


def moe_ffn_einsum(lp: dict, cfg, x: torch.Tensor):
    """Chunked one-hot einsum dispatch (Switch/GShard style).

    Tokens go in chunks of ``Tc`` (the largest divisor of ``T`` up to
    ``TOKEN_CHUNK``); the capacity is per chunk, ``Cc = ceil(Tc*K/E *
    capacity_factor)``, so the one-hot stays ``(Tc, E, Cc)``.  Under
    autograd each chunk is recomputed in the backward."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    Tc = min(TOKEN_CHUNK, T)
    while T % Tc:
        Tc -= 1
    Cc = capacity(cfg, Tc)
    w = lp["moe"]
    args = (lp["router"], w["w_gate"], w["w_up"], w["w_down"], E, K, Cc)
    me_sum = torch.zeros((E,), dtype=_F32, device=x.device)
    ce_sum = torch.zeros((E,), dtype=_F32, device=x.device)
    ys = []
    for xc in torch.split(xt, Tc):
        if torch.is_grad_enabled():
            p_sum, c_sum, yc = checkpoint(_einsum_chunk, xc, *args,
                                          use_reentrant=False)
        else:
            p_sum, c_sum, yc = _einsum_chunk(xc, *args)
        me_sum = me_sum + p_sum
        ce_sum = ce_sum + c_sum
        ys.append(yc)
    aux = E * torch.sum((me_sum / T) * (ce_sum / (T * K)))
    return torch.cat(ys).reshape(B, S, D), aux


# ---------------------------------------------------------------- forward
def _block(x, aux, lp, cfg, pos, mask_kind, window):
    x = x + cm.self_attention(lp["attn"], cfg, cm.rms_norm(x, lp["ln1"]), pos,
                              mask_kind=mask_kind, window=window)
    y, a = moe_ffn(lp, cfg, cm.rms_norm(x, lp["ln2"]))
    return x + y, aux + a


def forward(params: dict, cfg, tokens: torch.Tensor, *, window: int = 0,
            remat: bool = False):
    """tokens: (B, S) -> (logits (B, S, V), aux loss summed over layers).

    ``remat``: each layer under ``torch.utils.checkpoint`` (the reference
    scans its layers under ``jax.remat``)."""
    x, pos = dense._prompt_rows(params, cfg, tokens)
    mk = "window" if window else "causal"
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for lp in cm.layer_list(params, "layers/", cfg.n_layers):
        if remat:
            x, aux = checkpoint(_block, x, aux, lp, cfg, pos, mk, window,
                                use_reentrant=False)
        else:
            x, aux = _block(x, aux, lp, cfg, pos, mk, window)
    x = cm.rms_norm(x, params["ln_f"])
    return cm.unembed(x, params["unembed"]), aux


def loss(params: dict, cfg, batch: dict) -> torch.Tensor:
    """Mean next-token xent plus ``AUX_LOSS_WEIGHT`` times the aux loss,
    each layer recomputed in the backward."""
    logits, aux = forward(params, cfg, batch["tokens"], remat=True)
    return cm.softmax_xent(logits, batch["labels"]) + AUX_LOSS_WEIGHT * aux


# ---------------------------------------------------------------- serving
def _ffn(lp: dict, cfg, h: torch.Tensor) -> torch.Tensor:
    return moe_ffn(lp, cfg, h)[0]


cache_spec = dense.cache_spec
init_cache = dense.init_cache


def prefill(params: dict, cfg, tokens: torch.Tensor, cache_len: int, *,
            window: int = 0):
    """``dense.prefill`` with the expert layer: (last-token logits, cache).
    The capacity counts the whole prompt batch's tokens."""
    return dense.prefill(params, cfg, tokens, cache_len, window=window,
                         ffn=_ffn)


def last_logits(params: dict, cfg, tokens: torch.Tensor, *,
                window: int = 0) -> torch.Tensor:
    """``prefill``'s last-token logits, bit for bit, without the cache."""
    return dense.last_logits(params, cfg, tokens, window=window, ffn=_ffn)


def decode_step(params: dict, cfg, cache: dict, token: torch.Tensor, *,
                window: int = 0):
    """One decode step (``dense.decode_step`` with the expert layer; the
    cache is consumed).  The capacity is the step's, ``T = B`` tokens: a
    decode step's logits are not the full forward's when picks collide."""
    return dense.decode_step(params, cfg, cache, token, window=window,
                             ffn=_ffn)
