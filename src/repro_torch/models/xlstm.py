"""xLSTM LM (arXiv:2405.04517): alternating mLSTM / sLSTM blocks, stacked in
(mLSTM, sLSTM) pairs.

- mLSTM (matrix memory, exponential gating) runs its chunkwise-parallel,
  stabilised form over a sequence: quadratic within a chunk of at most
  ``cfg.ssm_chunk`` tokens, the recurrent ``(C, n, m)`` state carried across
  chunks, so that a prefill and the one-step recurrent decode agree.
- sLSTM (scalar memory, recurrent gate connections) is sequential: one cell
  step a token.  The input products of its four gates run over the whole
  sequence before the loop; a step is one batched product of the hidden
  state with the four gates' block-diagonal recurrent weights, laid out
  once a call as ``(H, hd, 4 hd)`` (each output element is still one dot
  product over ``hd``), then the gates' elementwise math.  Under autograd
  the steps run as one ``torch.autograd.Function`` whose backward through
  time is written by hand (``_SLSTMScan``).

``d_ff = 0``: there is no separate MLP; the up / down projections live in
the cells (projection factor 2).  The head size is ``2 * d_model /
n_heads`` (``_dims``), not ``cfg.head_dim``.

Decoding carries a recurrent state and no KV cache: ``state_spec`` gives
its ``{name: (shape, dtype)}`` under flat keys (``mlstm/C``, ``mlstm/m``,
``mlstm/n``, ``pos``, ``slstm/c``, ``slstm/h``, ``slstm/m``, ``slstm/n``,
each stacked over the pairs but ``pos``), and ``decode_step`` updates the
state in place.  Params are the reference's tree flattened by
``repro_torch.convert``, every pair leaf stacked ``(n_layers // 2, ...)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..convert import flatten
from . import common as cm

PF = 2                         # block-internal projection factor
_F32 = torch.float32
_MLSTM = ("C", "n", "m")
_SLSTM = ("c", "n", "h", "m")


def _dims(cfg):
    """(d_model, inner width, heads, head size)."""
    D = cfg.d_model
    Di = PF * D
    H = cfg.n_heads
    return D, Di, H, Di // H


def _chunk_len(chunk: int, T: int) -> int:
    """The reference's chunk length: ``min(chunk, T)``, less one until it
    divides ``T`` (the chunking sets the rounding)."""
    cl = max(1, min(chunk, T))
    while T % cl:
        cl -= 1
    return cl


# ------------------------------------------------------------------- init
def init(cfg, device: str | torch.device = "cuda",
         generator: torch.Generator | None = None) -> dict:
    """Random parameters on ``device``, keyed and stacked as the reference's
    tree flattened by ``repro_torch.convert``: ``embed``, ``ln_f``,
    ``unembed`` and ``pairs/mlstm/*``, ``pairs/slstm/*`` with a leading
    axis of ``n_layers // 2`` (``pairs/slstm/r`` is ``(P, 4, H, hd, hd)``).
    The forget-gate biases start at 3.0.  The draws come from
    ``generator`` (default: a CPU generator seeded 0)."""
    if cfg.n_layers % 2:
        raise ValueError(f"{cfg.name}: xLSTM stacks (mLSTM, sLSTM) pairs, "
                         f"n_layers={cfg.n_layers} is odd")
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    D, Di, H, hd = _dims(cfg)
    dt, P = cm.pdtype(cfg), (cfg.n_layers // 2,)

    def w(shape, fan_in):
        return cm.dense_init(gen, P + shape, fan_in, dt, device)

    def full(shape, value):
        return torch.full(P + shape, value, dtype=dt, device=device)

    tree = {
        "embed": cm.dense_init(gen, (cfg.vocab, D), D, dt, device),
        "pairs": {
            "mlstm": {
                "ln": full((D,), 1.0),
                "w_up": w((D, 2 * Di), D),          # [cell in | out gate]
                "wq": w((Di, Di), Di), "wk": w((Di, Di), Di),
                "wv": w((Di, Di), Di),
                "wi": w((Di, H), Di), "wf": w((Di, H), Di),
                "bi": full((H,), 0.0), "bf": full((H,), 3.0),
                "w_down": w((Di, D), Di),
            },
            "slstm": {
                "ln": full((D,), 1.0),
                "w_up": w((D, Di), D),
                "wz": w((Di, Di), Di), "wi": w((Di, Di), Di),
                "wf": w((Di, Di), Di), "wo": w((Di, Di), Di),
                "r": w((4, H, hd, hd), hd),         # block-diagonal, a gate
                "bz": full((Di,), 0.0), "bi": full((Di,), 0.0),
                "bf": full((Di,), 3.0), "bo": full((Di,), 0.0),
                "w_down": w((Di, D), Di),
            },
        },
        "ln_f": torch.ones((D,), dtype=dt, device=device),
        "unembed": cm.dense_init(gen, (D, cfg.vocab), D, dt, device),
    }
    return flatten(tree)


# --------------------------------------------------------- mLSTM parallel
def _mlstm_gates(lp: dict, xi: torch.Tensor):
    """xi: (B, T, Di) cell input -> q, k, v (B, T, H, hd), i, f (B, T, H)
    f32."""
    B, T, Di = xi.shape
    H = lp["wi"].shape[1]
    hd = Di // H
    dt = xi.dtype
    q = torch.matmul(xi, lp["wq"].to(dt)).reshape(B, T, H, hd)
    k = torch.matmul(xi, lp["wk"].to(dt)).reshape(B, T, H, hd)
    v = torch.matmul(xi, lp["wv"].to(dt)).reshape(B, T, H, hd)
    i = (torch.matmul(xi, lp["wi"].to(dt)) + lp["bi"].to(dt)).to(_F32)
    f = (torch.matmul(xi, lp["wf"].to(dt)) + lp["bf"].to(dt)).to(_F32)
    return q, k, v, i, f


def mlstm_init_state(B: int, H: int, hd: int, device=None) -> dict:
    """A zero mLSTM state ``{C (B, H, hd, hd), n (B, H, hd), m (B, H)}``."""
    return {"C": torch.zeros((B, H, hd, hd), dtype=_F32, device=device),
            "n": torch.zeros((B, H, hd), dtype=_F32, device=device),
            "m": torch.zeros((B, H), dtype=_F32, device=device)}


def _mlstm_chunk(qc, kc, vc, ic, fc, C0, n0, m0, causal):
    """One chunk: the quadratic intra-chunk form against the carried state;
    returns h (B, cl, H, hd) and the end-of-chunk (C, n, m)."""
    lf = F.logsigmoid(fc)                            # (B, cl, H)
    Fc = torch.cumsum(lf, dim=1)
    a = ic - Fc
    mt = Fc + torch.maximum(m0[:, None], torch.cummax(a, dim=1).values)
    w0 = torch.exp(Fc + m0[:, None] - mt)            # the state's weight
    logw = Fc[:, :, None, :] + a[:, None, :, :] - mt[:, :, None, :]
    w = torch.where(causal, torch.exp(logw), 0.0)
    scores = torch.einsum("bthk,bshk->btsh", qc, kc)
    sw = scores * w
    num = torch.einsum("btsh,bshv->bthv", sw, vc) \
        + w0[..., None] * torch.einsum("bhvk,bthk->bthv", C0, qc)
    den_dot = sw.sum(2) + w0 * torch.einsum("bhk,bthk->bth", n0, qc)
    den = torch.maximum(torch.abs(den_dot), torch.exp(-mt))
    h = num / den[..., None]
    m_end = mt[:, -1]
    wend = torch.exp(Fc[:, -1][:, None] + a - m_end[:, None])   # (B, s, H)
    w0e = torch.exp(Fc[:, -1] + m0 - m_end)
    C = w0e[..., None, None] * C0 + torch.einsum(
        "bshv,bshk->bhvk", wend[..., None] * vc, kc)
    n = w0e[..., None] * n0 + torch.einsum("bsh,bshk->bhk", wend, kc)
    return h, C, n, m_end


def mlstm_chunked(lp: dict, cfg, xi: torch.Tensor, state: dict):
    """Chunkwise-parallel stabilised mLSTM over xi (B, T, Di): (h (B, T,
    Di), final state).  The ``(C, n, m)`` state goes from chunk to chunk in
    a Python loop."""
    q, k, v, i, f = _mlstm_gates(lp, xi)
    B, T, H, hd = q.shape
    cl = _chunk_len(cfg.ssm_chunk, T)
    parts = [torch.split(x, cl, dim=1) for x in (
        q.to(_F32) / math.sqrt(hd), k.to(_F32), v.to(_F32), i, f)]
    causal = cm.causal_mask(cl, xi.device)[None, :, :, None]
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for qc, kc, vc, ic, fc in zip(*parts):
        h, C, n, m = _mlstm_chunk(qc, kc, vc, ic, fc, C, n, m, causal)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, T, H * hd)
    return h.to(xi.dtype), {"C": C, "n": n, "m": m}


def mlstm_block(lp: dict, cfg, x: torch.Tensor, state: dict | None = None):
    """x: (B, T, D) -> (x + the block's output, final state)."""
    _, Di, H, hd = _dims(cfg)
    if state is None:
        state = mlstm_init_state(x.shape[0], H, hd, x.device)
    h = cm.rms_norm(x, lp["ln"])
    up = torch.matmul(h, lp["w_up"].to(h.dtype))
    xi, g = torch.chunk(up, 2, dim=-1)
    y, state = mlstm_chunked(lp, cfg, xi, state)
    y = y * F.silu(g)
    return x + torch.matmul(y, lp["w_down"].to(h.dtype)), state


def mlstm_decode(lp: dict, cfg, x: torch.Tensor, state: dict):
    """The one-step recurrent form.  x: (B, 1, D); ``state`` (``C``, ``n``,
    ``m`` of ``mlstm_init_state``'s shapes) is updated in place and
    returned with the block's output."""
    h = cm.rms_norm(x, lp["ln"])
    up = torch.matmul(h, lp["w_up"].to(h.dtype))
    xi, g = torch.chunk(up, 2, dim=-1)
    q, k, v, i, f = _mlstm_gates(lp, xi)
    q, k, v = q[:, 0].to(_F32), k[:, 0].to(_F32), v[:, 0].to(_F32)  # (B,H,hd)
    i, f = i[:, 0], f[:, 0]                                          # (B,H)
    B, H, hd = q.shape
    C, n, m = state["C"], state["n"], state["m"]
    a = F.logsigmoid(f) + m
    m_new = torch.maximum(a, i)
    fp = torch.exp(a - m_new)[..., None]
    ip = torch.exp(i - m_new)[..., None]
    n.mul_(fp).add_(ip * k)
    # C = fp C + ip v k^T, the rank-one update as one batched product
    C.mul_(fp[..., None]).view(B * H, hd, hd).baddbmm_(
        (ip * v).reshape(B * H, hd, 1), k.reshape(B * H, 1, hd))
    m.copy_(m_new)
    qs = q / math.sqrt(hd)
    num = torch.matmul(C, qs[..., None])[..., 0]
    den = torch.maximum(torch.abs(torch.sum(n * qs, dim=-1)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).to(x.dtype).reshape(B, 1, H * hd)
    y = y * F.silu(g)
    return x + torch.matmul(y, lp["w_down"].to(x.dtype)), state


# ------------------------------------------------------------ sLSTM scan
def _slstm_recurrent(r: torch.Tensor) -> torch.Tensor:
    """The four gates' recurrent weights ``(4, H, hd, hd)`` as one ``(H,
    hd, 4 hd)`` operand: column ``g * hd + l`` of head ``h`` is ``r[g, h,
    :, l]``."""
    G, H, hd, _ = r.shape
    return r.to(_F32).permute(1, 2, 0, 3).reshape(H, hd, G * hd)


class _Steps(NamedTuple):
    """Every step of an sLSTM run, kept in buffers written in place: the
    pre-activations (T, H, B, 4 hd) (z, i, f, o), the exponential gates'
    ``ip``, ``fp`` (T, 2, H, B, hd), the new h (T, H, B, hd), and c, n, m
    (T + 1, H, B, hd) from the initial state on."""

    pre: torch.Tensor
    ex: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def _slstm_loop(x4, R, h, c, n, m) -> _Steps:
    """The cell over the steps of x4 (T, H, B, 4 hd), input
    pre-activations, from the state (h, c, n, m), each (H, B, hd); R:
    ``_slstm_recurrent``.  One step: ``pre = x + h R`` (the four gates'
    recurrent products in one batched product), then

        z = tanh(pz), o = sigmoid(po), a = logsigmoid(pf) + m,
        m' = max(a, pi), ip = exp(pi - m'), fp = exp(a - m'),
        c' = fp c + ip z, n' = fp n + ip, h' = o c' / max(n', 1),

    each result written into its step's view of a buffer allocated once a
    call (the views are taken once, not a step at a time)."""
    T, H, B, G = x4.shape
    hd = G // 4
    st = _Steps(x4.new_empty(x4.shape), x4.new_empty((T, 2, H, B, hd)),
                x4.new_empty((T, H, B, hd)),
                *(torch.cat([s[None], s.new_empty((T, H, B, hd))])
                  for s in (c, n, m)))
    one = x4.new_ones(())
    steps = zip(torch.unbind(x4), torch.unbind(st.pre),
                *(torch.unbind(v) for v in torch.split(st.pre, hd, dim=-1)),
                *(torch.unbind(v) for v in (st.ex, st.ex[:, 0], st.ex[:, 1],
                                             st.h, st.c[1:], st.n[1:],
                                             st.m[1:])))
    for x, pre, pz, pi, pf, po, ex, ip, fp, h_, c_, n_, m_ in steps:
        torch.baddbmm(x, h, R, out=pre)
        z = torch.tanh(pz)
        o = torch.sigmoid(po)
        a = F.logsigmoid(pf) + m
        m = torch.maximum(a, pi, out=m_)
        torch.exp(torch.sub(torch.stack([pi, a]), m), out=ex)
        c = torch.addcmul(fp * c, ip, z, out=c_)
        n = torch.addcmul(ip, fp, n, out=n_)
        h = torch.div(o * c, torch.maximum(n, one), out=h_)
    return st


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM over a sequence with its backward through time written by
    hand.  Autograd over the step loop records some twenty nodes a token
    and spends most of a training step in its engine; here the forward
    keeps every step's pre-activations, gates and state (``_Steps``: a few
    MB a layer beside the weights), the backward derives the gates'
    factors for all steps at once and walks back through time with 11
    launches a step (the c and n gradients travel stacked), and the
    recurrent weights' gradient is one batched product over all steps.
    ``max`` passes half its gradient to each side of a tie, as
    ``jnp.maximum``'s does (``n`` is exactly 1 wherever a step opens on a
    zero state).

    Inputs: x4 (T, H, B, 4 hd), R (H, hd, 4 hd), h0, c0, n0, m0 (H, B, hd);
    outputs: the steps' h (T, H, B, hd) and the last c, n, m."""

    @staticmethod
    def forward(ctx, x4, R, h0, c0, n0, m0):
        st = _slstm_loop(x4, R, h0, c0, n0, m0)
        ctx.save_for_backward(R, h0, *st)
        return st.h, st.c[-1].clone(), st.n[-1].clone(), st.m[-1].clone()

    @staticmethod
    def backward(ctx, gy, gc, gn, gm):
        R, h0, pre, ex, h, cs, ns, ms = ctx.saved_tensors
        T, H, B, hd = h.shape
        pz, pi, pf, po = torch.split(pre, hd, dim=-1)
        ip, fp = ex[:, 0], ex[:, 1]
        c_prev, c, n_prev, n = cs[:-1], cs[1:], ns[:-1], ns[1:]
        # the forward's gates and every step's factors, for all steps at once
        z = torch.tanh(pz)
        o = torch.sigmoid(po)
        a = F.logsigmoid(pf) + ms[:-1]
        den = torch.clamp_min(n, 1.0)
        w_n = (n > 1).to(_F32) + 0.5 * (n == 1).to(_F32)
        w_a = (a > pi).to(_F32) + 0.5 * (a == pi).to(_F32)
        # d[c; n] += dh AB, d po = dh Do, d pz = dc Dz
        AB = torch.stack([o / den, -(h / den) * w_n], dim=1)
        Do = c / den * o * (1 - o)
        Dz = ip * (1 - z * z)
        g_ip = torch.stack([z * ip, ip], dim=1)               # . [dc; dn]
        g_fp = torch.stack([c_prev * fp, n_prev * fp], dim=1)
        M = torch.stack([g_ip, g_fp, g_ip + g_fp], dim=1)     # (T, 3, 2, ...)
        W = torch.stack([1 - w_a, w_a], dim=1)                # max's split
        S = torch.stack([torch.ones_like(pf), torch.sigmoid(-pf)], dim=1)
        del pz, pi, pf, po, z, o, a, den, w_n, w_a, g_ip, g_fp, c_prev, c, n
        d_pre = torch.empty_like(pre)
        dz, _, _, do = torch.split(d_pre, hd, dim=-1)
        d_if = d_pre.view(T, H, B, 4, hd)[:, :, :, 1:3].permute(0, 3, 1, 2, 4)
        gy = torch.zeros_like(h) if gy is None else gy
        dh = gy[T - 1]
        D = torch.stack([torch.zeros_like(h0) if g is None else g
                         for g in (gc, gn)])                  # [dc; dn]
        dm = torch.zeros_like(h0) if gm is None else gm
        RT = R.transpose(1, 2)
        steps = zip(*(torch.unbind(v) for v in (
            AB, Do, Dz, M, W, S, fp, d_pre, dz, do, d_if)),
            (None, *torch.unbind(gy)[:-1]))
        for t, (AB_, Do_, Dz_, M_, W_, S_, fp_, dp, dz_, do_, dif, gy_) in \
                reversed(list(enumerate(steps))):
            D = torch.addcmul(D, dh, AB_)
            torch.mul(dh, Do_, out=do_)
            torch.mul(D[0], Dz_, out=dz_)
            G = torch.mul(D, M_).sum(1)          # g_ip, g_fp, their sum
            # [d pi; d a]: the exps' own terms, then max's share of d m'
            IA = torch.addcmul(G[:2], dm - G[2], W_)
            torch.mul(IA, S_, out=dif)           # d pf = d a sigmoid(-pf)
            dm = IA[1]                           # a = ft + m: d m = d a
            D = D * fp_
            dh = torch.baddbmm(gy_, dp, RT) if t else torch.bmm(dp, RT)
        h_prev = torch.cat([h0[None], h[:-1]])
        dR = torch.bmm(h_prev.permute(1, 3, 0, 2).reshape(H, hd, T * B),
                       d_pre.permute(1, 0, 2, 3).reshape(H, T * B, 4 * hd))
        return d_pre, dR, dh, D[0], D[1], dm


def _slstm_inputs(lp: dict, xi: torch.Tensor) -> torch.Tensor:
    """The four gates' input pre-activations of xi (..., Di) in f32, each
    ``xi @ w + b``, stacked on a new axis -2 after splitting Di into
    heads: (..., H, 4, hd)."""
    H = lp["r"].shape[-3]
    dt = xi.dtype
    gates = [(torch.matmul(xi, lp[w].to(dt)) + lp[b].to(dt)).to(_F32)
             for w, b in (("wz", "bz"), ("wi", "bi"), ("wf", "bf"),
                          ("wo", "bo"))]
    return torch.stack([g.reshape(*g.shape[:-1], H, -1) for g in gates],
                       dim=-2)


def slstm_seq(lp: dict, cfg, xi_seq: torch.Tensor, state: dict):
    """The sLSTM over xi_seq (B, T, Di) from ``state`` (each (B, Di)):
    (h (B, T, Di), final state).  The steps do the same operations in any
    chunking, so the reference's chunks (its remat boundaries) have no
    twin here; under autograd the steps run as ``_SLSTMScan``."""
    B, T, Di = xi_seq.shape
    _, _, H, hd = _dims(cfg)
    x4 = _slstm_inputs(lp, xi_seq).reshape(B, T, H, 4 * hd)
    x4 = x4.permute(1, 2, 0, 3).contiguous()          # (T, H, B, 4 hd)
    R = _slstm_recurrent(lp["r"])
    st = [state[k].reshape(B, H, hd).transpose(0, 1) for k in ("h", "c", "n",
                                                               "m")]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x4, R, *st)):
        hs, *last = _SLSTMScan.apply(x4, R, *st)
    else:
        run = _slstm_loop(x4, R, *st)
        hs, last = run.h, (run.c[-1], run.n[-1], run.m[-1])
    y = hs.permute(2, 0, 1, 3).reshape(B, T, Di)
    final = {k: v.transpose(0, 1).reshape(B, Di)
             for k, v in zip(("h", "c", "n", "m"), (hs[-1], *last))}
    return y.to(xi_seq.dtype), {k: final[k] for k in _SLSTM}


def slstm_init_state(cfg, B: int, device=None) -> dict:
    """A zero sLSTM state ``{c, n, h, m}``, each (B, Di) f32."""
    _, Di, _, _ = _dims(cfg)
    return {k: torch.zeros((B, Di), dtype=_F32, device=device)
            for k in _SLSTM}


def slstm_block(lp: dict, cfg, x: torch.Tensor, state: dict | None = None):
    """x: (B, T, D) -> (x + the block's output, final state)."""
    if state is None:
        state = slstm_init_state(cfg, x.shape[0], x.device)
    h = cm.rms_norm(x, lp["ln"])
    xi = torch.matmul(h, lp["w_up"].to(h.dtype))
    y, state = slstm_seq(lp, cfg, xi, state)
    return x + torch.matmul(y, lp["w_down"].to(h.dtype)), state


def slstm_decode(lp: dict, cfg, x: torch.Tensor, state: dict):
    """One step.  x: (B, 1, D); ``state`` (``c``, ``n``, ``h``, ``m``, each
    (B, Di)) is updated in place and returned with the block's output."""
    h = cm.rms_norm(x, lp["ln"])
    xi = torch.matmul(h, lp["w_up"].to(h.dtype))[:, 0]         # (B, Di)
    B, Di = xi.shape
    H = lp["r"].shape[-3]
    hd = Di // H
    x4 = _slstm_inputs(lp, xi).reshape(B, H, 4 * hd).transpose(0, 1)
    st = {k: v.view(B, H, hd).transpose(0, 1) for k, v in state.items()}
    run = _slstm_loop(x4[None], _slstm_recurrent(lp["r"]), st["h"],
                      st["c"], st["n"], st["m"])
    for k, v in zip(("h", "c", "n", "m"), (run.h, run.c, run.n, run.m)):
        st[k].copy_(v[-1])
    y = state["h"][:, None].to(x.dtype)
    return x + torch.matmul(y, lp["w_down"].to(x.dtype)), state


# ---------------------------------------------------------------- forward
def _run(params: dict, cfg, tokens: torch.Tensor,
         keep_state=None) -> torch.Tensor:
    """Tokens (B, T) through every pair from a zero state: the last
    hidden rows (B, T, D); each pair's final (mLSTM, sLSTM) states go to
    ``keep_state`` when one is given."""
    x = cm.embed_tokens(params["embed"], tokens, cm.cdtype(cfg))
    for lp in cm.layer_list(params, "pairs/", cfg.n_layers // 2):
        x, mst = mlstm_block(lp["mlstm"], cfg, x)
        x, sst = slstm_block(lp["slstm"], cfg, x)
        if keep_state is not None:
            keep_state(mst, sst)
    return x


def forward(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, T) -> logits (B, T, V)."""
    x = _run(params, cfg, tokens)
    x = cm.rms_norm(x, params["ln_f"])
    return cm.unembed(x, params["unembed"])


def loss(params: dict, cfg, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B, T), "labels": (B, T)} -> mean xent (f32) over
    every position."""
    logits = forward(params, cfg, batch["tokens"])
    return cm.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------- serving
def state_spec(cfg, B: int) -> dict:
    """``{name: (shape, dtype)}`` of the recurrent decode state: mLSTM
    ``(C, n, m)`` and sLSTM ``(c, n, h, m)`` stacked over the ``P =
    n_layers // 2`` pairs, f32, and the 0-d int32 ``pos``; keys in the
    reference tree's flattened order."""
    _, Di, H, hd = _dims(cfg)
    P = cfg.n_layers // 2
    return flatten({
        "mlstm": {"C": ((P, B, H, hd, hd), _F32), "n": ((P, B, H, hd), _F32),
                  "m": ((P, B, H), _F32)},
        "slstm": {k: ((P, B, Di), _F32) for k in _SLSTM},
        "pos": ((), torch.int32),
    })


def init_state(cfg, B: int, device: str | torch.device = "cuda") -> dict:
    """A zero state of ``state_spec``'s shapes on ``device``."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in state_spec(cfg, B).items()}


def _pair_states(state: dict, P: int):
    """The state's per-pair (mLSTM, sLSTM) dicts of views (from one
    ``unbind`` a leaf): writing into them writes into the stacks."""
    m = [torch.unbind(state[f"mlstm/{k}"]) for k in _MLSTM]
    s = [torch.unbind(state[f"slstm/{k}"]) for k in _SLSTM]
    return [(dict(zip(_MLSTM, [x[p] for x in m])),
             dict(zip(_SLSTM, [x[p] for x in s]))) for p in range(P)]


def decode_step(params: dict, cfg, state: dict, token: torch.Tensor):
    """One decode step.  token: (B,) int; state from ``init_state`` or
    ``prefill``.  Returns (logits (B, V), state): the input state is
    consumed (each pair's state is updated in place, the same tensors come
    back, with ``pos`` advanced by one); pass a clone to keep the old
    one."""
    with torch.no_grad():
        P = cfg.n_layers // 2
        x = cm.embed_tokens(params["embed"], token[:, None], cm.cdtype(cfg))
        for lp, (mst, sst) in zip(cm.layer_list(params, "pairs/", P),
                                  _pair_states(state, P)):
            x, _ = mlstm_decode(lp["mlstm"], cfg, x, mst)
            x, _ = slstm_decode(lp["slstm"], cfg, x, sst)
        x = cm.rms_norm(x, params["ln_f"])
        logits = cm.unembed(x, params["unembed"])[:, 0]
    return logits, {**state, "pos": state["pos"] + 1}


def prefill(params: dict, cfg, tokens: torch.Tensor, cache_len: int = 0,
            **_):
    """The chunkwise-parallel prompt: (last-token logits (B, V), the
    recurrent state stacked over the pairs with ``pos = T``).  A state has
    no positions: ``cache_len`` and ``window`` are ignored, as in the
    reference."""
    ms, ss = [], []

    def keep_state(mst, sst):
        ms.append(mst)
        ss.append(sst)

    logits = _last_logits(params, cfg, tokens, keep_state)
    state = {f"mlstm/{k}": torch.stack([s[k] for s in ms]) for k in _MLSTM}
    state.update({f"slstm/{k}": torch.stack([s[k] for s in ss])
                  for k in _SLSTM})
    state["pos"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                device=logits.device)
    return logits, {k: state[k] for k in state_spec(cfg, 1)}


def _last_logits(params, cfg, tokens, keep_state=None):
    x = _run(params, cfg, tokens, keep_state)
    x = cm.rms_norm(x[:, -1:], params["ln_f"])
    return cm.unembed(x, params["unembed"])[:, 0]


def last_logits(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """``prefill``'s last-token logits (B, V), bit for bit, without
    stacking the state: the stateless forward that coded serving
    replicates."""
    return _last_logits(params, cfg, tokens)
