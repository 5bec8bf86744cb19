"""Plain reference of the sparse-expert LM (OLMoE's block as the program
runs it), in float32 on one sequence at a time.

A layer: ``x + attn(rms(x) g1)``, then ``+ moe(rms(. ) g2)``.  Attention:
projections to 16 heads of 128, an RMS norm over each head's query and key
(gains ``q_norm``, ``k_norm``), rotary positions pairing the first half of
a head with the second (theta 10000), causal softmax attention scaled by
``1/sqrt(head_dim)``.  The expert layer: a float32 router, softmax over the
experts, the top ``k`` picks with their gates renormalised to sum to one
(floor 1e-9); each expert takes its picks in token order up to a capacity
of ``ceil(T k / E * capacity_factor)`` slots for the ``T`` tokens of the
forward and drops the rest; a kept pick adds ``gate * swiglu_e(x)``.  The
load-balance term of a layer is ``E * sum_e mean_t(p_te) * picks_e / (T k)``
(picks kept or not).  The loss of a sequence is the mean next-token cross
entropy plus ``router_aux_loss_coef`` times the layers' load-balance terms.
RMS norms take ``rms_norm_eps``.

Attention goes a block of queries at a time, so no more than a block's
scores are alive.  Departures of the program from the published OLMoE that
this reference shares are listed in the configuration's file.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .ops import Products

Q_BLOCK = 1024


def _rms(x, gain, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * gain


def _rope(x, theta):
    """x: (S, H, hd), positions 0..S-1."""
    S, _, hd = x.shape
    freqs = torch.as_tensor(
        1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd)),
        dtype=torch.float32, device=x.device)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(p, m, h, mm):
    S, D = h.shape
    H, hd = m["num_attention_heads"], m["head_dim"]
    Hkv = m["num_key_value_heads"]
    q = mm(h, p["wq"].reshape(D, H * hd)).reshape(S, H, hd)
    k = mm(h, p["wk"].reshape(D, Hkv * hd)).reshape(S, Hkv, hd)
    v = mm(h, p["wv"].reshape(D, Hkv * hd)).reshape(S, Hkv, hd)
    if m.get("qk_norm"):
        q = _rms(q, p["q_norm"], m["rms_norm_eps"])
        k = _rms(k, p["k_norm"], m["rms_norm_eps"])
    q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    rep = H // Hkv
    qh = q.transpose(0, 1)                                   # (H, S, hd)
    kh = k.transpose(0, 1).repeat_interleave(rep, 0)
    vh = v.transpose(0, 1).repeat_interleave(rep, 0)
    outs = []
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        s = mm(qh[:, a:b], kh[:, :b].transpose(1, 2).contiguous()) / math.sqrt(hd)
        qi = torch.arange(a, b, device=h.device)[:, None]
        kj = torch.arange(b, device=h.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
        outs.append(mm(torch.softmax(s, dim=-1), vh[:, :b]))
    o = torch.cat(outs, dim=1).transpose(0, 1).reshape(S, H * hd)
    return mm(o, p["wo"].reshape(H * hd, D))


def _experts(p, m, h, mm):
    """The expert layer on ``h (T, D)``: ``(y, load-balance term)``."""
    T, D = h.shape
    E, K = m["num_experts"], m["num_experts_per_tok"]
    probs = torch.softmax(mm(h, p["router"]), dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)
    if m.get("norm_topk_prob"):
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    cap = int(math.ceil(T * K / E * m["capacity_factor"]))
    flat = eidx.reshape(-1)                                  # token-major picks
    onehot = F.one_hot(flat, E)
    slot = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1    # earlier picks of its expert
    kept = slot < cap
    gates = gate.reshape(-1)
    y = torch.zeros_like(h)
    for e in range(E):
        picks = torch.nonzero((flat == e) & kept)[:, 0]
        if picks.numel() == 0:
            continue
        tok = picks // K
        rows = h[tok]
        act = F.silu(mm(rows, p["w_gate"][e])) * mm(rows, p["w_up"][e])
        y = y.index_add(0, tok, mm(act, p["w_down"][e]) * gates[picks, None])
    load = onehot.sum(0).to(torch.float32)
    aux = E * torch.sum(probs.mean(0) * load / (T * K))
    return y, aux


def _layer(params, i):
    return {k[len("layers/"):].split("/")[-1]: v[i]
            for k, v in params.items() if k.startswith("layers/")}


def hidden(params, m, tokens, products: Products):
    """Final-norm hidden states ``(S, D)`` of one sequence and the summed
    load-balance term."""
    mm, eps = products.mm, m["rms_norm_eps"]
    x = params["embed"][tokens.long()]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(m["num_hidden_layers"]):
        p = _layer(params, i)
        x = x + _attention(p, m, _rms(x, p["ln1"], eps), mm)
        y, a = _experts(p, m, _rms(x, p["ln2"], eps), mm)
        x, aux = x + y, aux + a
    return _rms(x, params["ln_f"], eps), aux


def loss(params, m, tokens, labels, products: Products):
    """One sequence's loss: mean cross entropy plus the weighted
    load-balance terms."""
    h, aux = hidden(params, m, tokens, products)
    z = products.mm(h, params["unembed"])
    xent = torch.mean(torch.logsumexp(z, -1)
                      - z.gather(-1, labels.long()[:, None])[:, 0])
    return xent + m["router_aux_loss_coef"] * aux


def train_from_seed(c: dict, seed: int, device, steps: int,
                    products: Products, transform=None):
    """The configuration's first ``steps`` NAG steps from its own inputs,
    made anew from the seed: each step's gradient is the mean over the
    ``n`` subsets (one sequence each) of their losses' gradients.  Returns
    ``(losses, first gradient, starting parameters, parameters after the
    steps)``; a step's loss is the mean of its subsets' losses.
    ``transform(batch, subsets)`` changes each step's batch first (a fault
    planted for the control's measurements)."""
    from harness import inputs
    from .nag import NAG
    tc, n = c["train"], c["code"][0]
    if tc["rows_per_subset"] != 1:
        raise ValueError("the reference takes one sequence a subset")
    y0 = inputs.lm_weights(c, seed, device)
    pool = inputs.token_batches(tc["batches"], n, tc["seq_len"],
                                c["vocab_size"], seed, device)
    opt, y = NAG(tc["lr"], y0), y0
    losses, first = [], None
    for step in range(steps):
        batch = {k: v[step] for k, v in pool.items()}
        if transform is not None:
            batch = transform(batch, n)
        leaves = {k: v.detach().requires_grad_(True) for k, v in y.items()}
        total = 0.0
        for j in range(n):
            lj = loss(leaves, c, batch["tokens"][j], batch["labels"][j],
                      products)
            lj.backward()
            total += float(lj.detach())
            del lj
        g = {k: v.grad / n for k, v in leaves.items()}
        del leaves
        losses.append(total / n)
        first = g if first is None else first
        y = opt.step(y, g)
        del g
    return losses, first, y0, y
