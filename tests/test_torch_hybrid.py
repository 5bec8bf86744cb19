"""The port's hybrid (``zamba2-1.2b``: Mamba2 layers with one shared
attention block after every ``attn_every`` of them) against the reference's
``repro/models/mamba_hybrid.py``, on the reference's own random weights
carried across with ``repro_torch.convert`` and inputs made with numpy from
a seed, on two small configs:

- the reduced config: 2 layers, d_model 256, 4 heads of 64, ``ssm_state``
  16, ``ssm_head_dim`` 32 (16 SSM heads), ``ssm_chunk`` 16, ``attn_every``
  1: two groups of one layer;
- ``SHORT``: the same with 5 layers and ``attn_every`` 2, groups (0, 2),
  (2, 4), (4, 5): a short last group, as the full config's (36, 38).

Covered: ``init`` (keys, order, shapes, types, initial values; the full
size on ``meta``), ``_causal_conv`` and ``_split_proj``, ``ssd_chunked`` at
T = 32 (two chunks), 24 (chunks of 12), 13 (one chunk: below
``ssm_chunk``) and the prime 17 (chunks of 1),
``mamba_block`` and ``mamba_decode`` stepped over the same inputs (SSM
state and conv ring in place), ``forward``, ``loss`` and the gradient of
every leaf (autograd against ``jax.value_and_grad``), the shared block's
gradient as the sum over its applications, ``prefill`` with and without a
window (logits and every state leaf), ``last_logits`` equal to
``prefill``'s logits bit for bit, ``decode_step`` continued from the
reference's own prefill state, and a prompt of 1 or 2 tokens (the
reference's decode raises on its short conv ring; the port's prefill
refuses it).

Tolerances: rtol 1e-4 / atol 1e-5 on forwards and states (f32 on both
sides, the same products summed in other orders), the atol taken on the
compared array's scale (1e-5 times its largest magnitude when that is over
1); a gradient leaf to 1e-4 of its largest element (the trajectories'
tolerance).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import mamba_hybrid as jmh
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import mamba_hybrid as tmh

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-4, atol=1e-5)
CONFIGS = ["reduced", "short"]
# the reference's entry points compiled once a config and shape (op by op
# they dispatch for seconds a call)
_jforward = jax.jit(jmh.forward, static_argnums=1)
_jloss_grad = jax.jit(jax.value_and_grad(jmh.loss), static_argnums=1)
_jprefill = jax.jit(jmh.prefill, static_argnums=(1, 3),
                    static_argnames="window")
_jdecode = jax.jit(jmh.decode_step, static_argnums=1,
                   static_argnames="window")


def _cfg(which):
    red = jconfigs.get_config(ARCH).reduced()
    return red if which == "reduced" else dataclasses.replace(
        red, n_layers=5, attn_every=2)


_MODELS: dict = {}


def _model(which):
    if which not in _MODELS:
        cfg = _cfg(which)
        jp = jmh.init(jax.random.PRNGKey(0), cfg)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _MODELS[which] = cfg, jp, tp
    return _MODELS[which]


def _layer(jp, tp, cfg, i=0):
    """Layer ``i``'s Mamba params on both sides."""
    jl = jax.tree.map(lambda x: x[i], jp["mamba"])
    tl = tcm.layer_list(tp, "mamba/", cfg.n_layers)[i]
    return jl, tl


def _normal(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(cfg, seed, B, T):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T),
                                                dtype=np.int32)


def _close(got, want, what=""):
    """rtol 1e-4, atol 1e-5 on the scale of ``want`` (see above)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, err_msg=what,
                               rtol=TOL["rtol"], atol=TOL["atol"] * scale)


def _close_tree(got: dict, want_tree):
    want = convert.flatten(jax.tree.map(np.asarray, want_tree))
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k], what=k)


# ------------------------------------------------------------ the surface
def test_config_is_the_reference_config():
    jcfg, tcfg = jconfigs.get_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    red = tcfg.reduced()
    assert dataclasses.asdict(red) == dataclasses.asdict(jcfg.reduced())
    assert (red.n_layers, red.d_model, red.n_heads, red.head_dim_,
            red.ssm_state, red.ssm_head_dim, red.ssm_chunk,
            red.attn_every) == (2, 256, 4, 64, 16, 32, 16, 1)
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.head_dim_, tcfg.d_ff, tcfg.vocab, tcfg.ssm_state,
            tcfg.ssm_expand, tcfg.ssm_head_dim, tcfg.attn_every,
            tcfg.ssm_chunk) == (38, 2048, 32, 32, 64, 8192, 32000, 64, 2,
                                64, 6, 256)
    assert tcfg.family == "hybrid" and tapi.get_module(tcfg) is tmh
    assert tmh._dims(tcfg) == jmh._dims(jcfg) == (2048, 4096, 64, 64, 64)
    assert tmh._dims(red) == jmh._dims(red) == (256, 512, 16, 32, 16)


@pytest.mark.parametrize("which", ["full", *CONFIGS])
def test_group_slices_are_the_references(which):
    cfg = jconfigs.get_config(ARCH) if which == "full" else _cfg(which)
    got = tmh._group_slices(cfg)
    assert got == [tuple(g) for g in jmh._group_slices(cfg)]
    want = {"full": [(0, 6), (6, 12), (12, 18), (18, 24), (24, 30),
                     (30, 36), (36, 38)],
            "reduced": [(0, 1), (1, 2)],
            "short": [(0, 2), (2, 4), (4, 5)]}[which]
    assert got == want


def test_full_config_and_its_size():
    """The shapes the card runs: 1,170,473,856 parameters, 4.68 GB in
    f32."""
    cfg = tget_config(ARCH)
    shapes = tapi.init(cfg, "meta")
    n = sum(math.prod(v.shape) for v in shapes.values())
    assert n == 1_170_473_856
    assert round(n * 4 / 1e9, 2) == 4.68
    assert all(v.device.type == "meta" for v in shapes.values())
    assert tuple(shapes["mamba/in_proj"].shape) == (38, 2048, 8384)
    assert tuple(shapes["mamba/out_proj"].shape) == (38, 4096, 2048)
    assert tuple(shapes["mamba/conv_w"].shape) == (38, 4, 4224)
    assert tuple(shapes["shared_attn/attn/wq"].shape) == (2048, 32, 64)
    jshapes = jax.eval_shape(lambda: jmh.init(jax.random.PRNGKey(0),
                                              jconfigs.get_config(ARCH)))
    want = convert.flatten(jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                                        jshapes))
    assert list(want) == list(shapes)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in shapes.items()} == want


@pytest.mark.parametrize("which", CONFIGS)
def test_init_has_the_reference_tree(which):
    cfg, jp, tp = _model(which)
    mine = tapi.init(cfg, "cpu", torch.Generator().manual_seed(0))
    assert list(mine) == list(tp)
    assert list(mine)[:11] == [
        "embed", "ln_f", "mamba/A_log", "mamba/D", "mamba/conv_b",
        "mamba/conv_w", "mamba/dt_bias", "mamba/in_proj", "mamba/ln",
        "mamba/norm", "mamba/out_proj"]
    assert list(mine)[11:] == [
        "shared_attn/attn/wk", "shared_attn/attn/wo", "shared_attn/attn/wq",
        "shared_attn/attn/wv", "shared_attn/ln1", "shared_attn/ln2",
        "shared_attn/mlp/w_down", "shared_attn/mlp/w_gate",
        "shared_attn/mlp/w_up", "unembed"]
    for key in tp:
        assert mine[key].shape == tp[key].shape, key
        assert mine[key].dtype == tp[key].dtype == torch.float32, key
    for key, value in (("mamba/A_log", 0.0), ("mamba/D", 1.0),
                       ("mamba/dt_bias", -2.0), ("mamba/conv_b", 0.0),
                       ("mamba/ln", 1.0), ("mamba/norm", 1.0),
                       ("shared_attn/ln1", 1.0), ("shared_attn/ln2", 1.0),
                       ("ln_f", 1.0)):
        assert torch.equal(mine[key], torch.full_like(mine[key], value)), key
        assert torch.equal(mine[key], tp[key]), key
    bf16 = tmh.init(dataclasses.replace(cfg, param_dtype="bfloat16"), "meta")
    assert {k for k, v in bf16.items() if v.dtype == torch.float32} == \
        {"mamba/A_log", "mamba/D", "mamba/dt_bias"}


# ----------------------------------------------------------------- Mamba2
def test_causal_conv_and_split_proj_match_reference():
    cfg, jp, tp = _model("reduced")
    jl, tl = _layer(jp, tp, cfg)
    _, Di, _, _, N = tmh._dims(cfg)
    x = _normal(1, (2, 11, Di + 2 * N))
    _close(tmh._causal_conv(torch.from_numpy(x), tl["conv_w"], tl["conv_b"]),
           jmh._causal_conv(jnp.asarray(x), jl["conv_w"], jl["conv_b"]))
    h = _normal(2, (2, 11, cfg.d_model))
    want = jmh._split_proj(jl, cfg, jnp.asarray(h))
    got = tmh._split_proj(tl, cfg, torch.from_numpy(h))
    assert len(got) == len(want) + 1
    for name, g, w in zip(("z", "xin", "B", "C", "dt"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, what=name)
    # the pre-conv rows are the in_proj product's [x | B | C] columns
    proj = np.asarray(jnp.einsum("btd,de->bte", jnp.asarray(h),
                                 jl["in_proj"]))
    _close(got[-1], proj[..., Di:2 * Di + 2 * N])


@pytest.mark.parametrize("T,cl", [(32, 16), (24, 12), (13, 13), (17, 1)])
def test_ssd_chunked_matches_reference(T, cl):
    cfg, jp, tp = _model("reduced")
    jl, tl = _layer(jp, tp, cfg, 1)
    assert tmh._chunk_len(cfg.ssm_chunk, T) == cl
    h = _normal(T, (2, T, cfg.d_model))
    z, xin, Bm, Cm, dt = jmh._split_proj(jl, cfg, jnp.asarray(h))
    jy, jst = jmh.ssd_chunked(jl, cfg, xin, Bm, Cm, dt)
    ty, tst = tmh.ssd_chunked(tl, cfg, *(torch.from_numpy(np.array(a))
                                         for a in (xin, Bm, Cm, dt)))
    assert ty.shape == (2, T, tmh._dims(cfg)[1])
    assert tst.shape == (2, 16, 32, 16) and tst.dtype == torch.float32
    _close(ty, jy)
    _close(tst, jst)


def test_mamba_block_and_decode_match_reference():
    """``mamba_block`` over 9 tokens; ``mamba_decode`` stepped over the
    same 9 from a zero state on both sides: each step's output, the SSM
    state and the conv ring, updated in place."""
    cfg, jp, tp = _model("reduced")
    jl, tl = _layer(jp, tp, cfg)
    _, Di, H, hd, N = tmh._dims(cfg)
    x = _normal(3, (2, 9, cfg.d_model))
    _close(tmh.mamba_block(tl, cfg, torch.from_numpy(x)),
           jmh.mamba_block(jl, cfg, jnp.asarray(x)))
    jst = jnp.zeros((2, H, hd, N), jnp.float32)
    jconv = jnp.zeros((2, tmh.CONV_K - 1, Di + 2 * N), jnp.float32)
    tst, tconv = torch.zeros(2, H, hd, N), torch.zeros(2, 3, Di + 2 * N)
    st0, conv0 = tst, tconv
    for t in range(9):
        jy, jst, jconv = jmh.mamba_decode(jl, cfg, jnp.asarray(x[:, t:t + 1]),
                                          jst, jconv)
        ty, tst, tconv = tmh.mamba_decode(tl, cfg,
                                          torch.from_numpy(x[:, t:t + 1]),
                                          tst, tconv)
        _close(ty, jy, what=f"step {t}")
        _close(tst, jst, what=f"state {t}")
        _close(tconv, jconv, what=f"conv {t}")
    assert tst is st0 and tconv is conv0


def test_sequence_and_step_forms_agree():
    """Within the port: the chunked layer against the one-step decode over
    the same 16 tokens (the reference's ``test_models_math`` pair, at its
    5e-4), the final SSM state and the conv ring too."""
    cfg, _, tp = _model("reduced")
    lp = tcm.layer_list(tp, "mamba/", cfg.n_layers)[0]
    _, Di, H, hd, N = tmh._dims(cfg)
    x = torch.from_numpy(_normal(4, (2, 16, cfg.d_model)))
    want, want_st, want_conv = tmh._mamba_layer(lp, cfg, x)
    st, conv = torch.zeros(2, H, hd, N), torch.zeros(2, 3, Di + 2 * N)
    outs = [tmh.mamba_decode(lp, cfg, x[:, t:t + 1], st, conv)[0]
            for t in range(16)]
    torch.testing.assert_close(torch.cat(outs, 1), want, rtol=5e-4,
                               atol=5e-4)
    torch.testing.assert_close(st, want_st, rtol=5e-4, atol=5e-4)
    assert torch.equal(conv, want_conv)


# -------------------------------------------------- forward, loss, gradient
@pytest.mark.parametrize("which", CONFIGS)
def test_forward_matches_reference(which):
    cfg, jp, tp = _model(which)
    toks = _tokens(cfg, 5, 2, 24)
    want = _jforward(jp, cfg, jnp.asarray(toks))
    got = tmh.forward(tp, cfg, torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)
    # checkpointed layers compute the same bits
    assert torch.equal(tmh.forward(tp, cfg, torch.from_numpy(toks),
                                   remat=True), got)


def _grads(tp, cfg, batch, loss_fn):
    p = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    lval = loss_fn(p, batch)
    return lval.detach(), dict(zip(p, torch.autograd.grad(lval,
                                                          list(p.values()))))


@pytest.mark.parametrize("which", CONFIGS)
def test_loss_and_grad_match_reference(which):
    cfg, jp, tp = _model(which)
    toks = _tokens(cfg, 6, 2, 32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jl, jg = _jloss_grad(jp, cfg, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tg = _grads(tp, cfg, tb, tapi.make_loss(cfg))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    assert list(tg) == list(want)
    for k, g in tg.items():
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    # the loss is the xent of the forward over every position
    logits = tmh.forward(tp, cfg, tb["tokens"])
    assert torch.equal(tcm.softmax_xent(logits, tb["labels"]), tl)


@pytest.mark.parametrize("which", CONFIGS)
def test_shared_block_gradient_sums_its_applications(which, monkeypatch):
    """Each application of the shared block given its own copy of the
    weights: the copies' gradients sum to the shared gradient (the
    reference's, through ``jax.grad``), and no one application's alone is
    it."""
    cfg, jp, tp = _model(which)
    n_apps = len(tmh._group_slices(cfg))
    toks = _tokens(cfg, 7, 2, 32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jg = convert.flatten(jax.tree.map(np.asarray, _jloss_grad(
        jp, cfg, jax.tree.map(jnp.asarray, batch))[1])["shared_attn"])
    shared = {k[len("shared_attn/"):]: v for k, v in tp.items()
              if k.startswith("shared_attn/")}
    copies = [{k: v.detach().clone().requires_grad_() for k, v in
               shared.items()} for _ in range(n_apps)]
    app = iter(range(n_apps))
    block = tmh._attn_block

    def per_application(sp, *args):
        return block(convert.unflatten(copies[next(app)]), *args)

    monkeypatch.setattr(tmh, "_attn_block", per_application)
    logits = tmh.forward(tp, cfg, torch.from_numpy(toks))
    assert next(app, None) is None           # every application ran once
    lval = tcm.softmax_xent(logits, torch.from_numpy(batch["labels"]))
    leaves = [c[k] for c in copies for k in jg]
    per_app = torch.autograd.grad(lval, leaves)
    for i, k in enumerate(jg):
        parts = [per_app[a * len(jg) + i] for a in range(n_apps)]
        total = torch.stack(parts).sum(0).numpy()
        scale = float(np.abs(jg[k]).max())
        np.testing.assert_allclose(total, jg[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
        for a, part in enumerate(parts):
            gap = float(np.abs(part.numpy() - jg[k]).max())
            assert gap > 1e-3 * scale, f"{k}: application {a} alone"


# ------------------------------------------------------ prefill and decode
@pytest.mark.parametrize("which", CONFIGS)
@pytest.mark.parametrize("window", [0, 4])
def test_prefill_matches_reference(which, window):
    """Last-token logits and every state leaf (flat keys, the reference
    tree's order, the KV caches packed into ``cache_len`` or ring slots),
    ``pos = S``; ``last_logits``, ``make_prefill`` and ``make_forward``
    give the prefill's logits bit for bit."""
    cfg, jp, tp = _model(which)
    toks = _tokens(cfg, 8 + window, 2, 13)
    jl, jst = _jprefill(jp, cfg, jnp.asarray(toks), 20, window=window)
    tt = torch.from_numpy(toks)
    tl, tst = tmh.prefill(tp, cfg, tt, 20, window=window)
    _close(tl, jl)
    _close_tree(tst, jst)
    assert list(tst) == list(tapi.cache_spec(cfg, 2, 20, window=window))
    assert tst["pos"].dtype == torch.int32 and tst["pos"].shape == ()
    assert int(tst["pos"]) == 13
    assert tst["k"].shape[2] == (4 if window else 20)
    assert torch.equal(tmh.last_logits(tp, cfg, tt, window=window), tl)
    pl, pst = tapi.make_prefill(cfg, 20, window=window)(tp, {"tokens": tt})
    assert torch.equal(pl, tl) and all(torch.equal(pst[k], tst[k])
                                       for k in tst)
    assert torch.equal(tapi.make_forward(cfg, window=window)(
        tp, {"tokens": tt}), tl)


@pytest.mark.parametrize("which", CONFIGS)
@pytest.mark.parametrize("window", [0, 4])
def test_decode_continues_the_reference_prefill(which, window):
    """The reference's prefill state carried across with ``convert``, then
    four decode steps on both sides: logits and every state leaf; the
    port's state is consumed in place and ``pos`` advances.  The port's
    own prefill decodes to the same logits."""
    cfg, jp, tp = _model(which)
    toks = _tokens(cfg, 12 + window, 2, 16)
    _, jst = _jprefill(jp, cfg, jnp.asarray(toks[:, :12]), 16,
                       window=window)
    st = convert.params_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    assert list(st) == list(tmh.state_spec(cfg, 2, 16, window=window))
    assert st["pos"].dtype == torch.int32 and st["pos"].shape == ()
    held = {k: st[k] for k in ("ssm", "conv", "k", "v")}
    decode = tapi.make_decode(cfg, window=window)
    _, own = tmh.prefill(tp, cfg, torch.from_numpy(toks[:, :12]), 16,
                         window=window)
    for t in range(12, 16):
        jl, jst = _jdecode(jp, cfg, jst, jnp.asarray(toks[:, t]),
                           window=window)
        tl, st = decode(tp, st, torch.from_numpy(toks[:, t]))
        ol, own = tmh.decode_step(tp, cfg, own, torch.from_numpy(toks[:, t]),
                                  window=window)
        _close(tl, jl, what=f"step {t}")
        _close(ol, jl, what=f"own prefill, step {t}")
    assert all(st[k] is v for k, v in held.items()) and int(st["pos"]) == 16
    _close_tree(st, jst)


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_is_refused(S):
    """A prompt of fewer than ``CONV_K - 1`` tokens: the reference's
    prefill builds a conv ring of ``S`` rows and its own decode raises on
    it; the port's prefill refuses the prompt and says why."""
    cfg, jp, tp = _model("reduced")
    toks = _tokens(cfg, 30 + S, 2, 4)
    _, jst = _jprefill(jp, cfg, jnp.asarray(toks[:, :S]), 8)
    assert jst["conv"].shape[2] == S < tmh.CONV_K - 1
    with pytest.raises(ValueError, match="Size of label"):
        _jdecode(jp, cfg, jst, jnp.asarray(toks[:, S]))
    with pytest.raises(ValueError, match="CONV_K - 1 = 3"):
        tmh.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), 8)
    with pytest.raises(ValueError, match="conv ring"):
        tapi.make_prefill(cfg, 8)(tp, {"tokens": torch.from_numpy(
            toks[:, :S])})
    # three tokens fill the ring, and both sides decode
    jl, jst = _jprefill(jp, cfg, jnp.asarray(toks[:, :3]), 8)
    _, tst = tmh.prefill(tp, cfg, torch.from_numpy(toks[:, :3]), 8)
    jl, _ = _jdecode(jp, cfg, jst, jnp.asarray(toks[:, 0]))
    tl, _ = tmh.decode_step(tp, cfg, tst, torch.from_numpy(toks[:, 0]))
    _close(tl, jl)


def test_state_spec_and_init_state():
    cfg = _cfg("short")
    _, Di, H, hd, N = tmh._dims(cfg)
    spec = tmh.state_spec(cfg, 3, 40, window=8)
    assert spec == {"conv": ((5, 3, 3, Di + 2 * N), torch.float32),
                    "k": ((3, 3, 8, 4, 64), torch.float32),
                    "pos": ((), torch.int32),
                    "ssm": ((5, 3, H, hd, N), torch.float32),
                    "v": ((3, 3, 8, 4, 64), torch.float32)}
    assert tmh.state_spec(cfg, 3, 40)["k"][0] == (3, 3, 40, 4, 64)
    st = tmh.init_state(cfg, 3, 40, window=8, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in st.items()} == spec
    assert all(not v.any() for v in st.values())
    # the full config's state at 4 prompts of 4096 + 16 positions: the
    # SSM state (38, 4, 64, 64, 64), the conv rings, 7 KV caches
    full = tmh.state_spec(tget_config(ARCH), 4, 4112)
    assert full["ssm"][0] == (38, 4, 64, 64, 64)
    assert full["conv"][0] == (38, 4, 3, 4224)
    assert full["k"][0] == (7, 4, 4112, 32, 64)
    nbytes = {k: math.prod(s) * 4 for k, (s, _) in full.items()}
    assert round(nbytes["ssm"] / 1e9, 3) == 0.159
    assert round((nbytes["k"] + nbytes["v"]) / 1e9, 3) == 1.886

