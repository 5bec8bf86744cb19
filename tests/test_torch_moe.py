"""The port's MoE LM (``olmoe-1b-7b`` and ``grok-1-314b``, reduced: 2
layers, d_model 256, 4 experts, top 2) against the reference's
``repro/models/moe.py``, on the reference's own random weights carried
across with ``repro_torch.convert`` and inputs made with numpy from a seed.

- The configs are byte copies; ``init`` has the reference tree's keys,
  shapes and types; ``api`` serves the family and still refuses the four
  that are not ported.
- ``moe_ffn_scatter`` and ``moe_ffn_einsum`` (each picked by ``DISPATCH`` on
  both sides) on a random batch and on a batch that forces drops (one token
  row repeated: every row picks the same experts, past their capacity):
  the routing first, exactly (expert indices, slots and the keep mask),
  then ``y`` and ``aux`` at rtol = atol = 1e-4 (f32 on both sides, products
  summed in other orders).  Random inputs never overflow at these sizes,
  so each forced case asserts that picks were dropped.
- ``loss`` and its gradient against ``jax.value_and_grad``: the loss to
  rtol 1e-5, every gradient leaf to rtol 1e-4 plus 1e-4 of its largest
  element (the dense LM's tolerance).
- ``prefill`` and three ``decode_step``s against the reference's, from the
  same cache, including a batch whose decode picks collide and drop, on
  both dispatches (the einsum one in chunks of ``EINSUM_CHUNK`` tokens);
  ``last_logits`` is ``prefill``'s logits bit for bit.
"""
import dataclasses
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

ARCHS = ["olmoe-1b-7b", "grok-1-314b"]
TOL = dict(rtol=1e-4, atol=1e-4)
FILES = {"olmoe-1b-7b": "olmoe_1b_7b.py", "grok-1-314b": "grok_1_314b.py"}
# TOKEN_CHUNK of the einsum dispatch on the prefill and decode path: a
# prefill runs several chunks, each with its own capacity
EINSUM_CHUNK = 16


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = jconfigs.get_config(request.param).reduced()
    jp = jmoe.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


# ------------------------------------------------------------ the surface
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tget_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    ref = pathlib.Path(jconfigs.__file__).parent / FILES[arch]
    port = pathlib.Path(tcm.__file__).parents[1] / "configs" / FILES[arch]
    assert port.read_bytes() == ref.read_bytes()
    assert tcfg.family == "moe" and tapi.get_module(tcfg) is tmoe


def test_full_configs_and_their_capacities():
    """The shapes the card runs, and their capacities (a 4096-token
    prefill, decode steps at batch 1 and 4)."""
    olmoe, grok = tget_config("olmoe-1b-7b"), tget_config("grok-1-314b")
    assert (olmoe.n_layers, olmoe.d_model, olmoe.n_heads, olmoe.n_kv_heads,
            olmoe.head_dim_, olmoe.d_ff, olmoe.vocab, olmoe.n_experts,
            olmoe.top_k, olmoe.qk_norm) == \
        (16, 2048, 16, 16, 128, 1024, 50304, 64, 8, True)
    assert (grok.n_layers, grok.d_model, grok.n_experts, grok.top_k) == \
        (64, 6144, 8, 2)
    assert [tmoe.capacity(olmoe, T) for T in (1, 4, 4096)] == [1, 1, 640]
    assert [tmoe.capacity(grok, T) for T in (1, 4)] == [1, 2]
    for cfg in (olmoe, grok):
        for T in (1, 3, 16, 100, 4096):
            assert tmoe.capacity(cfg, T) == int(np.ceil(
                T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    shapes = tapi.init(olmoe, "meta")
    n = sum(math.prod(v.shape) for v in shapes.values())
    assert n == 6_919_100_416
    assert tuple(shapes["layers/moe/w_gate"].shape) == (16, 64, 2048, 1024)
    assert math.prod(shapes["layers/moe/w_gate"].shape) == 2 ** 31


@pytest.mark.parametrize("family", ["speech", "diffusion"])
def test_families_not_ported_are_refused(family):
    """A family outside the reference's zoo is refused, by a message that
    lists the ported ones; every family of the zoo is ported, the
    encoder-decoder last."""
    cfg = dataclasses.replace(tget_config("qwen3-1.7b").reduced(),
                              family=family)
    with pytest.raises(NotImplementedError, match=family):
        tapi.get_module(cfg)
    with pytest.raises(NotImplementedError, match="'encdec'.*'moe'"):
        tapi.make_loss(cfg)
    from repro_torch.models import encdec as ted
    assert tapi.get_module(tget_config("whisper-tiny")) is ted


def test_hybrid_family_is_the_ports_mamba_hybrid():
    from repro_torch.models import mamba_hybrid as tmh
    cfg = tget_config("zamba2-1.2b")
    assert cfg.family == "hybrid"
    assert tapi.get_module(cfg) is tmh
    assert tapi.get_module(dataclasses.replace(
        tget_config("qwen3-1.7b").reduced(), family="hybrid")) is tmh


def test_ssm_family_is_the_ports_xlstm():
    from repro_torch.models import xlstm as txlstm
    cfg = tget_config("xlstm-350m")
    assert cfg.family == "ssm"
    assert tapi.get_module(cfg) is txlstm
    assert tapi.get_module(dataclasses.replace(
        tget_config("qwen3-1.7b").reduced(), family="ssm")) is txlstm


def test_init_has_the_reference_tree(model):
    cfg, jp, tp = model
    mine = tapi.init(cfg, "cpu", torch.Generator().manual_seed(0))
    assert list(mine) == list(tp)
    for key in tp:
        assert mine[key].shape == tp[key].shape, key
        assert mine[key].dtype == torch.float32
    L, D, Fd, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    assert tuple(mine["layers/router"].shape) == (L, D, E)
    assert tuple(mine["layers/moe/w_down"].shape) == (L, E, Fd, D)
    assert torch.equal(mine["layers/ln2"], torch.ones(L, D))
    std = mine["layers/moe/w_down"].std().item() * np.sqrt(Fd)
    assert 0.9 < std < 1.1
    meta = tapi.init(cfg, "meta")
    assert {k: tuple(v.shape) for k, v in meta.items()} == \
        {k: tuple(v.shape) for k, v in mine.items()}


# ---------------------------------------------------------------- routing
def _record_reference_top_k(monkeypatch):
    """Record every ``jax.lax.top_k`` the reference makes, also inside its
    chunk scan (through a debug callback), as numpy index arrays."""
    seen = []
    orig = jax.lax.top_k

    def rec(x, k):
        v, i = orig(x, k)
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), i)
        return v, i

    monkeypatch.setattr(jax.lax, "top_k", rec)
    return seen


def _record_port_routing(monkeypatch):
    seen = {"eidx": [], "slots": []}
    route, dispatch, chunk = tmoe.route, tmoe.dispatch, tmoe.einsum_slots

    def rec_route(*a):
        out = route(*a)
        seen["eidx"].append(out[2].numpy())
        return out

    def rec_dispatch(*a):
        out = dispatch(*a)
        seen["slots"].append((out.slot.numpy(), out.keep.numpy()))
        return out

    def rec_chunk(*a):
        pos, keep = chunk(*a)
        seen["slots"].append((pos.numpy().reshape(-1).astype(np.int64),
                              keep.numpy().reshape(-1)))
        return pos, keep

    monkeypatch.setattr(tmoe, "route", rec_route)
    monkeypatch.setattr(tmoe, "dispatch", rec_dispatch)
    monkeypatch.setattr(tmoe, "einsum_slots", rec_chunk)
    return seen


def _slots(eidx, E, C):
    """The reference's slot and keep arithmetic (``moe.py:141-147``) in
    numpy: each pick's 0-based position among its expert's picks."""
    flat = eidx.reshape(-1)
    slot = np.array([np.sum(flat[:i] == e) for i, e in enumerate(flat)])
    return slot, slot < C


def _ffn_input(cfg, forced, seed=11):
    rng = np.random.default_rng(seed)
    if forced:      # one row repeated: every token picks the same K experts
        row = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
        return np.repeat(row, 16, axis=1)
    return rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("forced", [False, True], ids=["random", "forced"])
@pytest.mark.parametrize("dispatch,chunk", [("scatter", None),
                                            ("einsum", None),
                                            ("einsum", 8)])
def test_moe_ffn_matches_reference(model, monkeypatch, dispatch, chunk,
                                   forced):
    """Routing first, exactly; then the outputs.  ``chunk`` sets
    ``TOKEN_CHUNK`` on both sides (8: two chunks of 8 tokens, each with its
    own capacity)."""
    cfg, jp, tp = model
    monkeypatch.setattr(jmoe, "DISPATCH", dispatch)
    monkeypatch.setattr(tmoe, "DISPATCH", dispatch)
    if chunk:
        monkeypatch.setattr(jmoe, "TOKEN_CHUNK", chunk)
        monkeypatch.setattr(tmoe, "TOKEN_CHUNK", chunk)
    x = _ffn_input(cfg, forced)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    tlp = tcm.layer_list(tp, "layers/", cfg.n_layers)[0]
    ref_idx = _record_reference_top_k(monkeypatch)
    jy, jaux = jmoe.moe_ffn(jlp, cfg, jnp.asarray(x))
    jy = np.asarray(jy)
    seen = _record_port_routing(monkeypatch)
    with torch.no_grad():
        ty, taux = tmoe.moe_ffn(tlp, cfg, torch.from_numpy(x))

    T = x.shape[0] * x.shape[1]
    Tc = min(chunk or tmoe.TOKEN_CHUNK, T)
    C = tmoe.capacity(cfg, Tc if dispatch == "einsum" else T)
    assert len(ref_idx) == len(seen["eidx"]) == len(seen["slots"]) == T // Tc
    dropped = 0
    for want_e, got_e, (slot, keep) in zip(ref_idx, seen["eidx"],
                                           seen["slots"]):
        np.testing.assert_array_equal(got_e, want_e)
        want_slot, want_keep = _slots(want_e, cfg.n_experts, C)
        np.testing.assert_array_equal(slot, want_slot)
        np.testing.assert_array_equal(keep, want_keep)
        dropped += int((~keep).sum())
    if forced:
        # 16 (or 8 a chunk) picks of each of K experts against C = 10 (5)
        assert dropped == cfg.top_k * (T - (T // Tc) * C) > 0
    elif chunk is None:     # random rows stay within C = 10 (20) here
        assert dropped == 0
    np.testing.assert_allclose(ty.numpy(), jy, **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert taux.dtype == torch.float32 and taux.shape == ()


def test_dropped_picks_add_nothing_and_kept_ones_their_gate(model):
    """Scatter dispatch, forced drops: a token's output is the gate-weighted
    sum of its kept experts' SwiGLU alone, computed by hand."""
    cfg, _, tp = model
    x = torch.from_numpy(_ffn_input(cfg, True))
    lp = tcm.layer_list(tp, "layers/", cfg.n_layers)[0]
    with torch.no_grad():
        y, _ = tmoe.moe_ffn_scatter(lp, cfg, x)
        xt = x.reshape(-1, cfg.d_model)
        _, gate, eidx = tmoe.route(lp["router"], cfg.top_k, xt)
        r = tmoe.dispatch(eidx, cfg.n_experts, tmoe.capacity(cfg, 16))
        keep = r.keep.reshape(16, cfg.top_k)
        w = lp["moe"]
        for t in (0, 9, 15):
            want = torch.zeros(cfg.d_model)
            for k in range(cfg.top_k):
                if keep[t, k]:
                    e = int(eidx[t, k])
                    h = torch.nn.functional.silu(xt[t] @ w["w_gate"][e]) * (
                        xt[t] @ w["w_up"][e])
                    want = want + gate[t, k] * (h @ w["w_down"][e])
            np.testing.assert_allclose(y[0, t].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6)
    assert keep[:10].all() and not keep[10:].any()


# ------------------------------------------------------- loss and gradient
def _port_value_and_grad(tp, cfg, batch):
    p = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    lval = tmoe.loss(p, cfg, b)
    return lval, dict(zip(p, torch.autograd.grad(lval, list(p.values()))))


@pytest.mark.parametrize("forced", [False, True], ids=["random", "forced"])
@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_loss_and_grad_match_reference(model, monkeypatch, dispatch, forced):
    cfg, jp, tp = model
    monkeypatch.setattr(jmoe, "DISPATCH", dispatch)
    monkeypatch.setattr(tmoe, "DISPATCH", dispatch)
    toks = np.full((1, 16), 5, np.int32) if forced else \
        _tokens(4, 2, 16, cfg.vocab)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jl, jg = jax.value_and_grad(jmoe.loss)(jp, cfg,
                                          jax.tree.map(jnp.asarray, batch))
    tl, tg = _port_value_and_grad(tp, cfg, batch)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    assert set(tg) == set(want)
    for k, g in tg.items():
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * max(scale, 1e-12), err_msg=k)
    # the aux term is in the loss: the router gets a gradient from it even
    # where no token's output depends on an expert
    assert float(tmoe.forward(tp, cfg, torch.from_numpy(toks))[1]) > 0
    assert float(tg["layers/router"].abs().max()) > 0


def test_loss_checkpoint_changes_no_bit(model):
    """Each layer under ``torch.utils.checkpoint`` (the reference's remat)
    gives the loss and gradient of the plain forward, bit for bit, and a
    second gradient repeats the first."""
    cfg, _, tp = model
    toks = torch.from_numpy(_tokens(6, 2, 16, cfg.vocab))
    labels = torch.roll(toks, -1, dims=1)
    grads = []
    for remat in (True, False, True):
        p = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
        logits, aux = tmoe.forward(p, cfg, toks, remat=remat)
        lval = tcm.softmax_xent(logits, labels) + tmoe.AUX_LOSS_WEIGHT * aux
        grads.append((lval, torch.autograd.grad(lval, list(p.values()))))
    for lval, g in grads[1:]:
        assert torch.equal(lval, grads[0][0])
        assert all(torch.equal(a, b) for a, b in zip(g, grads[0][1]))
    direct = tapi.make_loss(cfg)(tp, {"tokens": toks, "labels": labels})
    assert torch.equal(direct, grads[0][0])


# ------------------------------------------------------ prefill and decode
def _record_keep(monkeypatch):
    """Record the keep mask of every dispatch the port runs, by dispatch:
    one a scatter dispatch, one an einsum chunk."""
    kept = {"scatter": [], "einsum": []}
    dispatch, chunk = tmoe.dispatch, tmoe.einsum_slots

    def rec(*a):
        out = dispatch(*a)
        kept["scatter"].append(out.keep)
        return out

    def rec_chunk(*a):
        pos, keep = chunk(*a)
        kept["einsum"].append(keep.reshape(-1))
        return pos, keep

    monkeypatch.setattr(tmoe, "dispatch", rec)
    monkeypatch.setattr(tmoe, "einsum_slots", rec_chunk)
    return kept


@pytest.mark.parametrize("collide,dispatch", [
    pytest.param(False, "scatter", id="random"),
    pytest.param(True, "scatter", id="collide"),
    pytest.param(False, "einsum", id="random-einsum"),
    pytest.param(True, "einsum", id="collide-einsum")])
def test_prefill_and_decode_match_reference(model, monkeypatch, collide,
                                            dispatch):
    """The reference's prefill cache, then three decode steps on both sides
    from it.  ``collide``: 4 copies of one prompt, so that at a decode
    step's capacity (``C = ceil(4*2/4*1.25) = 3``) the 4 picks of each
    chosen expert overflow and one is dropped; at B = 2 (``C = 2``) no
    decode ever drops.  ``dispatch`` is set on both sides; the einsum one
    runs the prefill in chunks of ``EINSUM_CHUNK`` tokens and a decode step
    (B tokens) in one."""
    cfg, jp, tp = model
    for mod in (jmoe, tmoe):
        monkeypatch.setattr(mod, "DISPATCH", dispatch)
        monkeypatch.setattr(mod, "TOKEN_CHUNK", EINSUM_CHUNK)
    B = 4 if collide else 2
    toks = _tokens(7, 1 if collide else B, 15, cfg.vocab)
    toks = np.repeat(toks, B, axis=0) if collide else toks
    jl, jcache = jmoe.prefill(jp, cfg, jnp.asarray(toks[:, :12]), 20)
    tl, tcache = tmoe.prefill(tp, cfg, torch.from_numpy(toks[:, :12]), 20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 12
    last = tmoe.last_logits(tp, cfg, torch.from_numpy(toks[:, :12]))
    assert torch.equal(last, tl)
    fwd = tapi.make_forward(cfg)(tp, {"tokens": torch.from_numpy(toks[:, :12])})
    assert torch.equal(fwd, tl)

    seen = _record_keep(monkeypatch)
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for t in range(12, 15):
        jl, jcache = jmoe.decode_step(jp, cfg, jcache,
                                      jnp.asarray(toks[:, t]))
        tl, cache = tmoe.decode_step(tp, cfg, cache,
                                     torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == 15
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **TOL)
    # the first layer of the first step sees 4 equal rows: each of the K
    # experts they pick drops its fourth pick; past it the row that lost its
    # picks differs from the others
    kept = seen[dispatch]
    assert not seen["einsum" if dispatch == "scatter" else "scatter"]
    drops = [int((~k).sum()) for k in kept]
    assert len(kept) == 3 * cfg.n_layers
    if collide:
        assert drops[0] == cfg.top_k
    else:
        assert sum(drops) == 0


def test_decode_is_not_the_forward_when_picks_collide(model):
    """Batch-dependent capacity, kept from the reference: a decode step of
    4 identical sequences drops picks the full forward keeps, so its logits
    are not the forward's last-token logits; with a capacity factor that
    never drops (``C = T*K``) the same decode is the forward's."""
    cfg, _, tp = model
    toks = torch.from_numpy(np.repeat(_tokens(8, 1, 9, cfg.vocab), 4, axis=0))
    roomy = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    for c, close in ((roomy, True), (cfg, False)):
        full = tmoe.forward(tp, c, toks)[0][:, -1]
        _, cache = tmoe.prefill(tp, c, toks[:, :8], 12)
        lg, _ = tmoe.decode_step(tp, c, cache, toks[:, 8])
        err = float((lg - full).abs().max())
        assert (err < 2e-4) == close, (c.capacity_factor, err)
