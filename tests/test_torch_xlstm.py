"""The port's xLSTM (``xlstm-350m``: (mLSTM, sLSTM) pairs) against the
reference's ``repro/models/xlstm.py``, on the reference's own random weights
carried across with ``repro_torch.convert`` and inputs made with numpy from
a seed, at the reduced size (2 layers = 1 pair, d_model 256, 4 heads of
128, vocab 512, ``ssm_chunk`` 16).

- The config has the reference's fields; ``init`` has the reference tree's
  keys, shapes and types, at the reduced and (on ``meta``) the full size.
- ``mlstm_chunked`` / ``mlstm_block`` and ``slstm_seq`` / ``slstm_block``
  (outputs and final states) at T = 32 (two chunks), 24 (chunks of 12), 13
  (one chunk: below ``ssm_chunk``) and the prime 17 (chunks of 1), from a
  zero and from a carried state; the one-step
  ``mlstm_decode`` / ``slstm_decode`` stepped over the same inputs.
- ``forward``, ``loss`` and its gradient for every leaf (autograd against
  ``jax.value_and_grad``); ``prefill`` (logits and every state leaf),
  ``last_logits`` equal to ``prefill``'s logits bit for bit;
  ``decode_step`` continued from the reference's own prefill state.

Tolerances: rtol 1e-4 / atol 1e-5 on forwards and states (f32 on both
sides, the same products summed in other orders), the atol taken on the
compared array's scale, 1e-5 times its largest magnitude when that is over
1: an mLSTM block's output reaches 11 at the reduced size (its ``h`` 47,
where the stabiliser's floor divides), and near its zero crossings an
element is 3.5e-5 from the reference's, 3e-6 of the largest.  A gradient
leaf to 1e-4 of its largest element (the trajectories' tolerance).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import xlstm as jx
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import xlstm_350m as txcfg
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import xlstm as tx

torch.set_num_threads(1)

ARCH = "xlstm-350m"
TOL = dict(rtol=1e-4, atol=1e-5)
LENGTHS = [32, 24, 13, 17]      # chunks of 16 (two), 12, 13 (one), 1


@pytest.fixture(scope="module")
def model():
    cfg = jconfigs.get_config(ARCH).reduced()
    jp = jx.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _pair(jp, tp, cfg, which):
    """Pair 0's ``which`` ("mlstm" / "slstm") params on both sides."""
    jl = jax.tree.map(lambda x: x[0], jp["pairs"])[which]
    tl = tcm.layer_list(tp, "pairs/", cfg.n_layers // 2)[0][which]
    return jl, tl


def _normal(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, what=""):
    """rtol 1e-4, atol 1e-5 on the scale of ``want`` (see above)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, err_msg=what,
                               rtol=TOL["rtol"], atol=TOL["atol"] * scale)


def _close_state(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        _close(got[k], want[k], what=k)


# ------------------------------------------------------------ the surface
def test_config_is_the_reference_config():
    jcfg, tcfg = jconfigs.get_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    red = tcfg.reduced()
    assert dataclasses.asdict(red) == dataclasses.asdict(jcfg.reduced())
    assert (red.n_layers, red.d_model, red.n_heads, red.vocab,
            red.ssm_chunk) == (2, 256, 4, 512, 16)
    assert tcfg.family == "ssm" and tapi.get_module(tcfg) is tx
    # the head size is 2 * d_model / n_heads, not head_dim
    assert tx._dims(tcfg) == jx._dims(jcfg) == (1024, 2048, 4, 512)
    assert tcfg.head_dim == 256
    assert tx._dims(red) == (256, 512, 4, 128)
    assert "2 * d_model / n_heads" in txcfg.__doc__


def test_full_config_and_its_size():
    """The shapes the card runs: 631,825,504 parameters, 2.53 GB in f32."""
    cfg = tget_config(ARCH)
    shapes = tapi.init(cfg, "meta")
    n = sum(math.prod(v.shape) for v in shapes.values())
    assert n == 631_825_504
    assert round(n * 4 / 1e9, 2) == 2.53
    assert all(v.device.type == "meta" and v.dtype == torch.float32
               for v in shapes.values())
    assert tuple(shapes["pairs/slstm/r"].shape) == (12, 4, 4, 512, 512)
    assert tuple(shapes["pairs/mlstm/w_up"].shape) == (12, 1024, 4096)
    assert tuple(shapes["pairs/slstm/wz"].shape) == (12, 2048, 2048)
    jshapes = jax.eval_shape(lambda: jx.init(jax.random.PRNGKey(0),
                                             jconfigs.get_config(ARCH)))
    want = convert.flatten(jax.tree.map(lambda s: s.shape, jshapes))
    assert list(want) == list(shapes)
    assert {k: tuple(v.shape) for k, v in shapes.items()} == \
        {k: tuple(v) for k, v in want.items()}


def test_init_has_the_reference_tree(model):
    cfg, jp, tp = model
    mine = tapi.init(cfg, "cpu", torch.Generator().manual_seed(0))
    assert list(mine) == list(tp)
    assert len(mine) == 25 and "pairs/slstm/r" in mine
    for key in tp:
        assert mine[key].shape == tp[key].shape, key
        assert mine[key].dtype == tp[key].dtype == torch.float32, key
    for key in ("pairs/mlstm/bf", "pairs/slstm/bf"):
        assert torch.equal(mine[key], torch.full_like(mine[key], 3.0))
        assert torch.equal(mine[key], tp[key])
    for key in ("pairs/mlstm/ln", "pairs/slstm/ln", "ln_f"):
        assert torch.equal(mine[key], torch.ones_like(mine[key]))
    meta = tapi.init(cfg, "meta")
    assert {k: tuple(v.shape) for k, v in meta.items()} == \
        {k: tuple(v.shape) for k, v in mine.items()}
    with pytest.raises(ValueError, match="pairs"):
        tx.init(dataclasses.replace(cfg, n_layers=3), "meta")


@pytest.mark.parametrize("T,cl", [(32, 16), (24, 12), (13, 13), (17, 1),
                                  (5, 5)])
def test_chunk_length_is_the_references(T, cl):
    assert tx._chunk_len(16, T) == cl


# ------------------------------------------------------------------ mLSTM
def _mlstm_state(jl, cfg, seed, B):
    """A state the mLSTM reaches: the reference's over 16 tokens from 0."""
    _, Di, H, hd = tx._dims(cfg)
    xi = _normal(seed, (B, 16, Di))
    _, st = jx.mlstm_chunked(jl, cfg, jnp.asarray(xi),
                             jx.mlstm_init_state(B, H, hd))
    return jax.tree.map(np.array, st)


@pytest.mark.parametrize("T", LENGTHS)
def test_mlstm_matches_reference(model, T):
    """``mlstm_block`` from a zero state and ``mlstm_chunked`` from a
    carried one: outputs and final states."""
    cfg, jp, tp = model
    jl, tl = _pair(jp, tp, cfg, "mlstm")
    _, Di, H, hd = tx._dims(cfg)
    x = _normal(T, (2, T, cfg.d_model))
    jy, jst = jx.mlstm_block(jl, cfg, jnp.asarray(x))
    ty, tst = tx.mlstm_block(tl, cfg, torch.from_numpy(x))
    _close(ty, jy)
    _close_state(tst, jst)
    xi = _normal(T + 1, (2, T, Di))
    st = _mlstm_state(jl, cfg, T + 2, 2)
    jy, jst = jx.mlstm_chunked(jl, cfg, jnp.asarray(xi),
                               jax.tree.map(jnp.asarray, st))
    ty, tst = tx.mlstm_chunked(tl, cfg, torch.from_numpy(xi),
                               {k: torch.from_numpy(v) for k, v in st.items()})
    assert ty.shape == (2, T, Di)
    _close(ty, jy)
    _close_state(tst, jst)


def test_mlstm_decode_matches_reference(model):
    """The one-step form stepped over 6 inputs from a carried state, the
    state updated in place."""
    cfg, jp, tp = model
    jl, tl = _pair(jp, tp, cfg, "mlstm")
    _, _, H, hd = tx._dims(cfg)
    x = _normal(3, (2, 6, cfg.d_model))
    st = _mlstm_state(jl, cfg, 4, 2)
    jst = jax.tree.map(jnp.asarray, st)
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    C = tst["C"]
    for t in range(6):
        jy, jst = jx.mlstm_decode(jl, cfg, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = tx.mlstm_decode(tl, cfg, torch.from_numpy(x[:, t:t + 1]),
                                  tst)
        _close(ty, jy, what=f"step {t}")
        _close_state(tst, jst)
    assert tst["C"] is C


# ------------------------------------------------------------------ sLSTM
def _slstm_state(seed, B, Di):
    st = {k: _normal(seed + i, (B, Di)) for i, k in enumerate("cnhm")}
    st["n"] = np.abs(st["n"]) + 0.5
    return st


@pytest.mark.parametrize("T", LENGTHS)
def test_slstm_matches_reference(model, T):
    """``slstm_block`` from a zero state and ``slstm_seq`` from a carried
    one: outputs and final states."""
    cfg, jp, tp = model
    jl, tl = _pair(jp, tp, cfg, "slstm")
    _, Di, _, _ = tx._dims(cfg)
    x = _normal(T, (2, T, cfg.d_model))
    jy, jst = jx.slstm_block(jl, cfg, jnp.asarray(x))
    ty, tst = tx.slstm_block(tl, cfg, torch.from_numpy(x))
    _close(ty, jy)
    _close_state(tst, jst)
    xi = _normal(T + 1, (2, T, Di))
    st = _slstm_state(T + 2, 2, Di)
    jy, jst = jx.slstm_seq(jl, cfg, jnp.asarray(xi),
                           jax.tree.map(jnp.asarray, st))
    ty, tst = tx.slstm_seq(tl, cfg, torch.from_numpy(xi),
                           {k: torch.from_numpy(v) for k, v in st.items()})
    assert ty.shape == (2, T, Di) and list(tst) == ["c", "n", "h", "m"]
    _close(ty, jy)
    _close_state(tst, jst)


@pytest.mark.parametrize("zero_state", [True, False])
def test_slstm_backward_matches_reference(model, zero_state):
    """The hand-written backward through time (``_SLSTMScan``) against
    ``jax.grad`` of the reference's ``slstm_seq``: the gradients of the
    recurrent and input weights, of the input and of the initial state,
    for a loss on every step's output and on the final state.  From a zero
    state ``n`` is exactly 1 wherever a step's input gate wins: the ties of
    ``max(n, 1)``."""
    cfg, jp, tp = model
    jl, tl = _pair(jp, tp, cfg, "slstm")
    _, Di, _, _ = tx._dims(cfg)
    T = 20
    keys = ("wz", "wi", "wf", "wo", "bz", "bi", "bf", "bo", "r")
    xi = _normal(11, (2, T, Di))
    st = ({k: np.zeros((2, Di), np.float32) for k in "cnhm"} if zero_state
          else _slstm_state(12, 2, Di))
    wy = _normal(13, (2, T, Di), 1.0)
    wst = {k: _normal(14 + i, (2, Di), 1.0) for i, k in enumerate("cnhm")}

    def jloss(w, x, s):
        y, fin = jx.slstm_seq({**jl, **w}, cfg, x, s)
        return jnp.sum(y * wy) + sum(jnp.sum(fin[k] * wst[k]) for k in wst)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        {k: jl[k] for k in keys}, jnp.asarray(xi),
        jax.tree.map(jnp.asarray, st))
    w = {k: tl[k].detach().clone().requires_grad_() for k in keys}
    x = torch.from_numpy(xi).requires_grad_()
    s = {k: torch.from_numpy(v).requires_grad_() for k, v in st.items()}
    y, fin = tx.slstm_seq(w, cfg, x, s)
    lval = (y * torch.from_numpy(wy)).sum() + sum(
        (fin[k] * torch.from_numpy(wst[k])).sum() for k in wst)
    tg = torch.autograd.grad(lval, [*w.values(), x, *s.values()])
    want = [*(jg[0][k] for k in keys), jg[1], *(jg[2][k] for k in s)]
    names = [*keys, "x", *(f"state/{k}" for k in s)]
    assert len(tg) == len(want)
    for name, g, wg in zip(names, tg, want):
        wg = np.asarray(wg)
        scale = float(np.abs(wg).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), wg, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def _cell_steps(x4, R, h, c, n, m):
    """The sLSTM's steps spelled as plain operations that autograd can
    record: the steps' h stacked and the last (c, n, m)."""
    hd = x4.shape[-1] // 4
    hs = []
    for x in torch.unbind(x4):
        pz, pi, pf, po = torch.split(x + torch.bmm(h, R), hd, dim=-1)
        a = torch.nn.functional.logsigmoid(pf) + m
        m = torch.maximum(a, pi)
        c = torch.exp(a - m) * c + torch.exp(pi - m) * torch.tanh(pz)
        n = torch.exp(a - m) * n + torch.exp(pi - m)
        h = torch.sigmoid(po) * c / torch.maximum(n, torch.ones_like(n))
        hs.append(h)
    return torch.stack(hs), c, n, m


def test_slstm_backward_matches_autograd_of_the_loop(model):
    """Within the port: ``_SLSTMScan`` (forward and hand-written backward)
    against autograd recording the cell's steps as plain operations."""
    cfg, _, tp = model
    tl = tcm.layer_list(tp, "pairs/", 1)[0]["slstm"]
    _, _, H, hd = tx._dims(cfg)
    x4 = torch.from_numpy(_normal(15, (24, H, 2, 4 * hd), 1.0))
    R = tx._slstm_recurrent(tl["r"])
    st = [torch.from_numpy(v).reshape(2, H, hd).transpose(0, 1)
          for v in _slstm_state(16, 2, H * hd).values()]
    wy = torch.from_numpy(_normal(17, (24, H, 2, hd), 1.0))
    outs = []
    for fn in (tx._SLSTMScan.apply, _cell_steps):
        leaves = [t.detach().clone().requires_grad_() for t in (x4, R, *st)]
        hs, *last = fn(*leaves)
        lval = (hs * wy).sum() + sum(v.sum() * (i + 1)
                                     for i, v in enumerate(last))
        outs.append(([hs.detach(), *(v.detach() for v in last)],
                     torch.autograd.grad(lval, leaves)))
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_slstm_decode_matches_reference(model):
    cfg, jp, tp = model
    jl, tl = _pair(jp, tp, cfg, "slstm")
    _, Di, _, _ = tx._dims(cfg)
    x = _normal(5, (2, 6, cfg.d_model))
    st = _slstm_state(6, 2, Di)
    jst = jax.tree.map(jnp.asarray, st)
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    h = tst["h"]
    for t in range(6):
        jy, jst = jx.slstm_decode(jl, cfg, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = tx.slstm_decode(tl, cfg, torch.from_numpy(x[:, t:t + 1]),
                                  tst)
        _close(ty, jy, what=f"step {t}")
        _close_state(tst, jst)
    assert tst["h"] is h


def test_sequence_and_step_forms_agree(model):
    """Within the port: the chunked mLSTM and the sLSTM loop against their
    one-step forms (the reference's ``test_models_math`` pair, at its
    2e-4)."""
    cfg, _, tp = model
    lp = tcm.layer_list(tp, "pairs/", 1)[0]
    _, _, H, hd = tx._dims(cfg)
    x = torch.from_numpy(_normal(8, (2, 24, cfg.d_model)))
    for which, block, step, st in (
            ("mlstm", tx.mlstm_block, tx.mlstm_decode,
             tx.mlstm_init_state(2, H, hd)),
            ("slstm", tx.slstm_block, tx.slstm_decode,
             tx.slstm_init_state(cfg, 2))):
        want, want_st = block(lp[which], cfg, x)
        outs = []
        for t in range(24):
            o, st = step(lp[which], cfg, x[:, t:t + 1], st)
            outs.append(o)
        torch.testing.assert_close(torch.cat(outs, 1), want, rtol=2e-4,
                                   atol=2e-4)
        for k in want_st:
            torch.testing.assert_close(st[k], want_st[k], rtol=2e-4,
                                       atol=2e-4)


# -------------------------------------------------- forward, loss, gradient
def _tokens(cfg, seed, B, T):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T),
                                                dtype=np.int32)


@pytest.mark.parametrize("T", [32, 17])
def test_forward_matches_reference(model, T):
    cfg, jp, tp = model
    toks = _tokens(cfg, T, 2, T)
    want = jx.forward(jp, cfg, jnp.asarray(toks))
    got = tx.forward(tp, cfg, torch.from_numpy(toks))
    assert got.shape == (2, T, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)


def test_loss_and_grad_match_reference(model):
    cfg, jp, tp = model
    toks = _tokens(cfg, 4, 2, 32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jl, jg = jax.value_and_grad(jx.loss)(jp, cfg,
                                        jax.tree.map(jnp.asarray, batch))
    p = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    tl = tapi.make_loss(cfg)(p, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    tg = dict(zip(p, torch.autograd.grad(tl, list(p.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    assert set(tg) == set(want)
    for k, g in tg.items():
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    # the loss is the xent of the forward over every position
    logits = tx.forward(tp, cfg, torch.from_numpy(toks))
    direct = tcm.softmax_xent(logits, torch.from_numpy(batch["labels"]))
    assert torch.equal(direct, tl.detach())


# ------------------------------------------------------ prefill and decode
@pytest.mark.parametrize("T", [32, 17])
def test_prefill_matches_reference(model, T):
    """Last-token logits and every state leaf (flat keys, the reference
    tree's order), ``pos = T``; ``last_logits``, ``make_prefill`` and
    ``make_forward`` give the prefill's logits bit for bit."""
    cfg, jp, tp = model
    toks = _tokens(cfg, 10 + T, 2, T)
    jl, jst = jx.prefill(jp, cfg, jnp.asarray(toks))
    tt = torch.from_numpy(toks)
    tl, tst = tx.prefill(tp, cfg, tt)
    _close(tl, jl)
    want = convert.flatten(jax.tree.map(np.asarray, jst))
    assert list(tst) == list(want) == list(tapi.cache_spec(cfg, 2, 0))
    for k in want:
        assert tst[k].dtype == (torch.int32 if k == "pos" else torch.float32)
        _close(tst[k], want[k], what=k)
    assert tst["pos"].shape == () and int(tst["pos"]) == T
    assert torch.equal(tx.last_logits(tp, cfg, tt), tl)
    pl, pst = tapi.make_prefill(cfg, 999, window=16)(tp, {"tokens": tt})
    assert torch.equal(pl, tl) and torch.equal(pst["mlstm/C"], tst["mlstm/C"])
    assert torch.equal(tapi.make_forward(cfg)(tp, {"tokens": tt}), tl)
    # the last position's logits of the full forward
    full = np.asarray(jx.forward(jp, cfg, jnp.asarray(toks)))[:, -1]
    _close(tl, full)


def test_decode_continues_the_reference_prefill(model):
    """The reference's prefill state carried across with ``convert``, then
    three decode steps on both sides: logits and every state leaf; the
    port's state is consumed in place and ``pos`` advances."""
    cfg, jp, tp = model
    toks = _tokens(cfg, 20, 2, 19)
    jl, jst = jx.prefill(jp, cfg, jnp.asarray(toks[:, :16]))
    st = convert.params_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    assert list(st) == list(tx.state_spec(cfg, 2))
    assert st["pos"].dtype == torch.int32 and st["pos"].shape == ()
    C = st["mlstm/C"]
    decode = tapi.make_decode(cfg, window=16)
    for t in range(16, 19):
        jl, jst = jx.decode_step(jp, cfg, jst, jnp.asarray(toks[:, t]))
        tl, st = decode(tp, st, torch.from_numpy(toks[:, t]))
        _close(tl, jl, what=f"step {t}")
    assert st["mlstm/C"] is C and int(st["pos"]) == 19
    want = convert.flatten(jax.tree.map(np.asarray, jst))
    for k in want:
        _close(st[k], want[k], what=k)
    # the port's own prefill decodes to the same logits
    _, own = tx.prefill(tp, cfg, torch.from_numpy(toks[:, :16]))
    for t in range(16, 19):
        ol, own = tx.decode_step(tp, cfg, own, torch.from_numpy(toks[:, t]))
    _close(ol, jl)


def test_state_spec_and_init_state(model):
    cfg = model[0]
    _, Di, H, hd = tx._dims(cfg)
    spec = tx.state_spec(cfg, 3)
    assert spec == {"mlstm/C": ((1, 3, H, hd, hd), torch.float32),
                    "mlstm/m": ((1, 3, H), torch.float32),
                    "mlstm/n": ((1, 3, H, hd), torch.float32),
                    "pos": ((), torch.int32),
                    "slstm/c": ((1, 3, Di), torch.float32),
                    "slstm/h": ((1, 3, Di), torch.float32),
                    "slstm/m": ((1, 3, Di), torch.float32),
                    "slstm/n": ((1, 3, Di), torch.float32)}
    st = tx.init_state(cfg, 3, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in st.items()} == spec
    assert all(not v.any() for v in st.values())
    full = tx.state_spec(tget_config(ARCH), 4)
    nbytes = sum(math.prod(s) * 4 for s, _ in full.values())
    assert round(nbytes / 1e9, 3) == 0.203
