"""The port's VLM (``internvl2-26b``: the InternLM2 backbone after stub
patch embeddings) against the reference's ``repro/models/vlm.py``, on the
reference's own random weights carried across with ``repro_torch.convert``
and inputs made with numpy from a seed.

- The config is a byte copy; ``init`` has the reference tree's keys, shapes
  and types; ``api`` serves the family.
- ``forward`` against ``vlm.forward``, and ``loss`` and its gradient against
  ``jax.value_and_grad(vlm.loss)`` (the loss on text positions only), at
  rtol = atol = 1e-4 (f32 on both sides, products summed in other orders;
  a gradient leaf to 1e-4 of its largest element, the dense LM's
  tolerance), on reduced ``internvl2-26b`` and on a variant with the card's
  q_per_kv = 6 and an odd vocabulary (92553 is odd).
- ``prefill`` at ``cache_len = P + S`` and longer, with a window, and past
  ``CHUNK_THRESHOLD`` (the online softmax), against ``vlm.prefill``, with
  ``cache["pos"] == P + S``; three ``decode_step``s after it against the
  reference's.
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
from repro.models import common as jcm
from repro.models import vlm as jvlm
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import flash_attn
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import dense as tdense
from repro_torch.models import vlm as tvlm

torch.set_num_threads(1)

ARCH = "internvl2-26b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _config(variant):
    """Reduced ``internvl2-26b``; ``gqa6``: 12 query heads on 2 KV heads of
    32 (the card's q_per_kv = 6) and an odd vocabulary."""
    cfg = jconfigs.get_config(ARCH).reduced()
    if variant == "gqa6":
        cfg = dataclasses.replace(cfg, n_heads=12, n_kv_heads=2, head_dim=32,
                                  vocab=509)
    return cfg


@pytest.fixture(scope="module", params=["reduced", "gqa6"])
def model(request):
    cfg = _config(request.param)
    jp = jvlm.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _inputs(cfg, seed, B, S):
    """Tokens (B, S) and patch embeddings (B, P, D), P the config's."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    emb = rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, emb


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------ the surface
def test_config_is_the_reference_config():
    jcfg, tcfg = jconfigs.get_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert tcfg.reduced().n_frontend_tokens == 8
    ref = pathlib.Path(jconfigs.__file__).parent / "internvl2_26b.py"
    port = pathlib.Path(tcm.__file__).parents[1] / "configs" / \
        "internvl2_26b.py"
    assert port.read_bytes() == ref.read_bytes()
    assert tcfg.family == "vlm" and tapi.get_module(tcfg) is tvlm


def test_full_config_and_its_size():
    """The shapes the card runs, and the sizes its depth cuts rest on."""
    cfg = tget_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab, cfg.n_frontend_tokens,
            cfg.qk_norm, cfg.param_dtype) == \
        (48, 6144, 48, 8, 128, 16384, 92553, 256, False, "float32")
    shapes = tapi.init(cfg, "meta")
    n = {k: math.prod(v.shape) for k, v in shapes.items()}
    layer = sum(v for k, v in n.items() if k.startswith("layers/")) // 48
    assert sum(v for k, v in n.items() if "/attn/" in k) // 48 == 88_080_384
    assert layer == 390_082_560
    outer = n["embed"] + n["unembed"] + n["ln_f"]
    assert n["embed"] == n["unembed"] == 92553 * 6144
    assert sum(n.values()) == 48 * layer + outer == 19_861_260_288
    # the card's cuts: 12 layers to serve (23.3 GB), 2 to train (7.67 GB)
    assert round((12 * layer + outer) * 4 / 1e9, 1) == 23.3
    assert round((2 * layer + outer) * 4 / 1e9, 2) == 7.67
    assert tuple(shapes["layers/attn/wk"].shape) == (48, 6144, 8, 128)


def test_init_has_the_reference_tree(model):
    cfg, jp, tp = model
    mine = tapi.init(cfg, "cpu", torch.Generator().manual_seed(0))
    assert list(mine) == list(tp) == list(tdense.init(cfg, "cpu"))
    for key in tp:
        assert mine[key].shape == tp[key].shape, key
        assert mine[key].dtype == torch.float32
    meta = tapi.init(cfg, "meta")
    assert {k: tuple(v.shape) for k, v in meta.items()} == \
        {k: tuple(v.shape) for k, v in mine.items()}


# -------------------------------------------------- forward, loss, gradient
def test_forward_matches_reference(model):
    cfg, jp, tp = model
    toks, emb = _inputs(cfg, 1, 2, 24)
    want = np.asarray(jvlm.forward(jp, cfg, jnp.asarray(toks),
                                   jnp.asarray(emb)))
    got = tvlm.forward(tp, cfg, *_t(toks, emb))
    assert got.shape == want.shape == (2, cfg.n_frontend_tokens + 24,
                                       cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the patches are the prefix: without them the text is another prompt
    plain = tdense.forward(tp, cfg, torch.from_numpy(toks))
    assert not torch.allclose(plain, got[:, cfg.n_frontend_tokens:],
                              rtol=1e-3, atol=1e-3)


def test_patches_are_cast_to_the_compute_dtype(model):
    """f64 patches give the f32 patches' logits, as the reference's
    ``astype`` does."""
    cfg, _, tp = model
    toks, emb = _t(*_inputs(cfg, 2, 1, 8))
    a = tvlm.forward(tp, cfg, toks, emb)
    b = tvlm.forward(tp, cfg, toks, emb.double())
    assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)


def _port_value_and_grad(tp, cfg, batch):
    p = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    lval = tapi.make_loss(cfg)(p, b)
    return lval, dict(zip(p, torch.autograd.grad(lval, list(p.values()))))


def test_loss_and_grad_match_reference(model):
    cfg, jp, tp = model
    toks, emb = _inputs(cfg, 4, 2, 16)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "embeds": emb}
    jl, jg = jax.value_and_grad(jvlm.loss)(jp, cfg,
                                          jax.tree.map(jnp.asarray, batch))
    tl, tg = _port_value_and_grad(tp, cfg, batch)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    assert set(tg) == set(want)
    for k, g in tg.items():
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * max(scale, 1e-12), err_msg=k)
    # text positions only: the loss is the xent of the forward's text rows
    P = cfg.n_frontend_tokens
    logits = tvlm.forward(tp, cfg, *_t(toks, emb))
    direct = tcm.softmax_xent(logits[:, P:], torch.from_numpy(batch["labels"]))
    assert torch.equal(direct, tl.detach())


def test_loss_checkpoint_changes_no_bit(model):
    """Each layer under ``torch.utils.checkpoint`` (the reference's remat)
    gives the plain forward's loss and gradient, bit for bit."""
    cfg, _, tp = model
    toks, emb = _t(*_inputs(cfg, 6, 2, 16))
    labels = torch.roll(toks, -1, dims=1)
    P = cfg.n_frontend_tokens
    grads = []
    for remat in (True, False, True):
        p = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
        logits = tvlm.forward(p, cfg, toks, emb, remat=remat)
        lval = tcm.softmax_xent(logits[:, P:], labels)
        grads.append((lval, torch.autograd.grad(lval, list(p.values()))))
    for lval, g in grads[1:]:
        assert torch.equal(lval, grads[0][0])
        assert all(torch.equal(a, b) for a, b in zip(g, grads[0][1]))
    direct = tvlm.loss(tp, cfg, {"tokens": toks, "labels": labels,
                                 "embeds": emb})
    assert torch.equal(direct, grads[0][0])


# ------------------------------------------------------ prefill and decode
def _check_cache(tc, jc, S):
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == S
    assert tc["pos"].dtype == torch.int32 and tc["pos"].shape == ()


@pytest.mark.parametrize("extra,window", [(0, 0), (12, 0), (40, 16)],
                         ids=["exact", "longer", "window"])
def test_prefill_matches_reference(model, extra, window):
    """``cache_len = P + S`` (the slots the prompt fills), a longer cache
    (zero-padded), and a sliding window of 16 ring slots; ``last_logits``,
    ``make_prefill`` and ``make_forward`` give the prefill's bits."""
    cfg, jp, tp = model
    S = 24
    toks, emb = _inputs(cfg, 3, 2, S)
    P = cfg.n_frontend_tokens
    cache_len = P + S + extra
    jl, jc = jvlm.prefill(jp, cfg, jnp.asarray(toks), cache_len,
                          embeds=jnp.asarray(emb), window=window)
    tt, te = _t(toks, emb)
    tl, tc = tvlm.prefill(tp, cfg, tt, cache_len, embeds=te, window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_cache(tc, jc, P + S)
    slots = min(cache_len, window) if window else cache_len
    assert tc["k"].shape[2] == slots
    batch = {"tokens": tt, "embeds": te}
    assert torch.equal(tvlm.last_logits(tp, cfg, tt, embeds=te,
                                        window=window), tl)
    pl, pc = tapi.make_prefill(cfg, cache_len, window=window)(tp, batch)
    assert torch.equal(pl, tl) and torch.equal(pc["k"], tc["k"])
    assert torch.equal(tapi.make_forward(cfg, window=window)(tp, batch), tl)
    # the last position's logits of the full forward
    if not window:
        full = np.asarray(jvlm.forward(jp, cfg, jnp.asarray(toks),
                                       jnp.asarray(emb)))[:, -1]
        np.testing.assert_allclose(tl.numpy(), full, **TOL)


def test_prefill_long_prompt_takes_the_online_softmax():
    """P + S = 8 + 2044 > CHUNK_THRESHOLD >= S: the patches take the
    prompt onto the online-softmax branch (on the CPU the flash kernel's
    plain version), once a layer."""
    cfg = _config("reduced")
    jp = jvlm.init(jax.random.PRNGKey(1), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    S = 2044
    P = cfg.n_frontend_tokens
    assert P + S > tcm.CHUNK_THRESHOLD == jcm.CHUNK_THRESHOLD >= S
    toks, emb = _inputs(cfg, 5, 1, S)
    jl, jc = jvlm.prefill(jp, cfg, jnp.asarray(toks), P + S,
                          embeds=jnp.asarray(emb))
    n0 = flash_attn.PLAIN_CALLS["flash_attention"]
    tl, tc = tapi.make_prefill(cfg, P + S)(
        tp, {"tokens": torch.from_numpy(toks), "embeds": torch.from_numpy(emb)})
    assert flash_attn.PLAIN_CALLS["flash_attention"] == n0 + cfg.n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_cache(tc, jc, P + S)


@pytest.mark.parametrize("window", [0, 16])
def test_decode_matches_reference(model, window):
    """The reference's prefill cache, then three decode steps on both sides
    from it (VLM decode is the dense LM's)."""
    cfg, jp, tp = model
    P = cfg.n_frontend_tokens
    toks, emb = _inputs(cfg, 7, 2, 15)
    assert tvlm.decode_step is tdense.decode_step
    jl, jcache = jvlm.prefill(jp, cfg, jnp.asarray(toks[:, :12]), P + 16,
                              embeds=jnp.asarray(emb), window=window)
    tl, tcache = tvlm.prefill(tp, cfg, torch.from_numpy(toks[:, :12]), P + 16,
                              embeds=torch.from_numpy(emb), window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_cache(tcache, jcache, P + 12)
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for t in range(12, 15):
        jl, jcache = jvlm.decode_step(jp, cfg, jcache, jnp.asarray(toks[:, t]),
                                      window=window)
        tl, cache = tapi.make_decode(cfg, window=window)(
            tp, cache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_cache(cache, jcache, P + 15)
    # the port's own cache decodes to the same logits
    _, own = tvlm.prefill(tp, cfg, torch.from_numpy(toks[:, :12]), P + 16,
                          embeds=torch.from_numpy(emb), window=window)
    for t in range(12, 15):
        ol, own = tvlm.decode_step(tp, cfg, own, torch.from_numpy(toks[:, t]),
                                   window=window)
    np.testing.assert_allclose(ol.numpy(), np.asarray(jl), **TOL)
    spec = tapi.cache_spec(cfg, 2, P + 16, window=window)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: s for k, (s, _) in spec.items()}
