"""The port's encoder-decoder (``whisper-tiny``: bidirectional encoder over
frame embeddings, causal decoder with cross-attention, learned positions)
against the reference's ``repro/models/encdec.py``, on the reference's own
random weights carried across with ``repro_torch.convert`` and inputs made
with numpy from a seed, at ``whisper-tiny.reduced()``: 2 + 2 layers,
d_model 256, 4 heads of 64, ``dec_ctx`` 64, 8 frames (``n_frontend_tokens``).

Covered: the config, ``init`` (keys, order, shapes, initial norms; the full
size on ``meta``: 61,822,464 parameters), ``encode`` (also with
``enc_pos`` tiled), ``decode_train``, ``loss`` and the gradient of every
leaf, the cache's shapes, ``prefill`` and 70 ``decode_step``s (70 passes
``dec_ctx = 64``: the self-KV ring wraps) with every cache leaf, and the
online branch at 2100 frames (above ``CHUNK_THRESHOLD``), where ``encode``
and ``_xattend`` take the flash kernel's plain version on the port's side
and ``online_attention`` on the reference's.  ROADMAP C.7 is recorded: the
reference's decode does not rotate q and k, its training forward does, so
greedy decode logits equal the teacher-forced ones at position 0 only, on
both sides alike.

Tolerances: forwards, the loss and the decode logits within 2e-5 of the
compared array's largest magnitude (f32 on both sides, the same products
summed in other orders); a gradient leaf within 1e-4 of its largest
element.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import common as jcm
from repro.models import encdec as jed
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import flash_attn
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import encdec as ted

torch.set_num_threads(1)

ARCH = "whisper-tiny"
REL = 2e-5
GRAD_REL = 1e-4
DECODE_STEPS = 70
# the reference's entry points compiled once a shape (op by op they
# dispatch for seconds a call)
_jencode = jax.jit(jed.encode, static_argnums=1)
_jdecode_train = jax.jit(jed.decode_train, static_argnums=1)
_jloss_grad = jax.jit(jax.value_and_grad(jed.loss), static_argnums=1)
_jprefill = jax.jit(jed.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(jed.decode_step, static_argnums=1)

_MODEL: dict = {}


def _model():
    if not _MODEL:
        cfg = jconfigs.get_config(ARCH).reduced()
        jp = jed.init(jax.random.PRNGKey(0), cfg)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _MODEL.update(cfg=cfg, jp=jp, tp=tp)
    return _MODEL["cfg"], _MODEL["jp"], _MODEL["tp"]


def _frames(cfg, seed, B, F):
    return np.random.default_rng(seed).standard_normal(
        (B, F, cfg.d_model)).astype(np.float32)


def _tokens(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _close(got, want, what="", rel=REL):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"


# ------------------------------------------------------------ the surface
def test_config_is_the_reference_config():
    jcfg, tcfg = jconfigs.get_config(ARCH), tget_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert (tcfg.family, tcfg.enc_layers, tcfg.n_layers, tcfg.d_model,
            tcfg.dec_ctx, tcfg.n_frontend_tokens) == \
        ("encdec", 4, 4, 384, 448, 1500)
    assert tapi.get_module(tcfg) is ted


def test_full_config_on_meta_has_the_reference_size():
    cfg = tget_config(ARCH)
    shapes = tapi.init(cfg, "meta")
    assert all(v.device.type == "meta" for v in shapes.values())
    assert sum(math.prod(v.shape) for v in shapes.values()) == 61_822_464
    want = jax.eval_shape(lambda: jed.init(jax.random.PRNGKey(0),
                                           jconfigs.get_config(ARCH)))
    want = convert.flatten(want)
    assert list(shapes) == list(want)
    for k in want:
        assert tuple(shapes[k].shape) == want[k].shape, k
    assert tuple(shapes["enc_pos"].shape) == (1500, 384)
    assert tuple(shapes["dec_layers/xattn/wk"].shape) == (4, 384, 6, 64)
    assert tuple(shapes["unembed"].shape) == (384, 51865)


def test_init_has_the_reference_tree():
    cfg, _, tp = _model()
    mine = tapi.init(cfg, "cpu", torch.Generator().manual_seed(0))
    assert list(mine) == list(tp)
    assert [k for k in mine if "/" not in k] == [
        "dec_pos", "embed", "enc_ln_f", "enc_pos", "ln_f", "unembed"]
    for key in tp:
        assert mine[key].shape == tp[key].shape, key
        assert mine[key].dtype == tp[key].dtype == torch.float32, key
    for key in ("enc_layers/ln1", "enc_layers/ln2", "enc_ln_f",
                "dec_layers/ln1", "dec_layers/lnx", "dec_layers/ln2", "ln_f"):
        assert torch.equal(mine[key], torch.ones_like(mine[key])), key
        assert torch.equal(mine[key], tp[key]), key


def test_cache_spec_is_the_reference_one():
    cfg, _, _ = _model()
    want = jed.cache_spec(cfg, 3, 11)
    got = tapi.cache_spec(cfg, 3, 11, window=16)     # window: ignored
    assert set(got) == set(want) == {"k", "v", "xk", "xv", "pos"}
    for k, (shape, dt) in got.items():
        assert shape == want[k].shape, k
        assert str(dt) == f"torch.{want[k].dtype}", k
    assert got["k"][0] == (2, 3, 64, 4, 64) and got["xk"][0] == (2, 3, 11, 4, 64)
    cache = tapi.init_cache(cfg, 3, 11, device="cpu")
    assert all(not v.any() for v in cache.values())
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("F", [8, 20])
def test_encode_matches_reference(F):
    """At the config's 8 frames, and at 20: ``enc_pos`` tiled 3 times."""
    cfg, jp, tp = _model()
    x = _frames(cfg, 1, 2, F)
    _close(ted.encode(tp, cfg, torch.from_numpy(x)),
           _jencode(jp, cfg, jnp.asarray(x)), f"encode F={F}")


def test_decode_train_matches_reference():
    cfg, jp, tp = _model()
    enc = _frames(cfg, 2, 2, 8)
    toks = _tokens(cfg, 3, 2, 24)
    _close(ted.decode_train(tp, cfg, torch.from_numpy(enc),
                            torch.from_numpy(toks)),
           _jdecode_train(jp, cfg, jnp.asarray(enc), jnp.asarray(toks)),
           "decode_train")


def test_loss_and_gradient_match_reference():
    cfg, jp, tp = _model()
    toks = _tokens(cfg, 4, 2, 24)
    batch = {"embeds": _frames(cfg, 5, 2, 8), "tokens": toks,
             "labels": np.roll(toks, -1, axis=1)}
    jl, jg = _jloss_grad(jp, cfg, jax.tree.map(jnp.asarray, batch))
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl = tapi.make_loss(cfg)(p, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    _close(tl, np.asarray(jl), "loss")
    grads = dict(zip(p, torch.autograd.grad(tl, list(p.values()))))
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    assert list(grads) == list(want)
    for k in want:
        _close(grads[k], want[k], f"grad {k}", rel=GRAD_REL)
    # both stacks and the cross-attention carry gradient
    for k in ("enc_pos", "enc_layers/attn/wq", "dec_layers/xattn/wk",
              "dec_pos"):
        assert float(grads[k].abs().max()) > 0, k


def test_loss_checkpoints_every_layer_of_both_stacks(monkeypatch):
    """``loss`` runs each encoder and each decoder layer under
    ``torch.utils.checkpoint`` (the reference's remat'd scans); a forward
    alone (``encode``, ``decode_train``) runs none."""
    cfg, _, tp = _model()
    seen = []
    real = ted.checkpoint

    def spy(fn, *a, **kw):
        seen.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(ted, "checkpoint", spy)
    toks = torch.from_numpy(_tokens(cfg, 6, 1, 8))
    batch = {"embeds": torch.from_numpy(_frames(cfg, 6, 1, 8)),
             "tokens": toks, "labels": toks}
    ted.decode_train(tp, cfg, ted.encode(tp, cfg, batch["embeds"]), toks)
    assert seen == []
    ted.loss(tp, cfg, batch)
    assert seen == ["_enc_block"] * cfg.enc_layers + \
        ["_dec_block"] * cfg.n_layers


# ---------------------------------------------------------------- serving
def test_prefill_and_decode_match_reference_through_the_ring():
    """``prefill`` (encode, cross-KV, one decode step on token 0), then 70
    greedy ``decode_step``s on both sides: past ``dec_ctx = 64`` the ring
    wraps.  Every step's logits; the caches' leaves at the end; ``pos``."""
    cfg, jp, tp = _model()
    x = _frames(cfg, 7, 2, 8)
    jl, jc = _jprefill(jp, cfg, jnp.asarray(x), 8)
    tl, tc = tapi.make_prefill(cfg, 8)(tp, {"embeds": torch.from_numpy(x)})
    _close(tl, jl, "prefill")
    assert int(tc["pos"]) == 1 and tc["pos"].dtype == torch.int32
    _close(tc["xk"], jc["xk"], "xk")
    _close(tc["xv"], jc["xv"], "xv")
    decode = tapi.make_decode(cfg)
    for t in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = _jdecode(jp, cfg, jc, jnp.asarray(tok))
        k_before = tc["k"]
        tl, tc = decode(tp, tc, torch.from_numpy(tok))
        assert tc["k"] is k_before                     # in place
        _close(tl, jl, f"decode step {t}")
    assert int(tc["pos"]) == int(jc["pos"]) == DECODE_STEPS + 1
    for key in ("k", "v", "xk", "xv"):
        _close(tc[key], jc[key], key)


def test_online_branch_at_2100_frames():
    """Above ``CHUNK_THRESHOLD`` the encoder's self-attention and the
    cross-attention go through the online softmax: the flash kernel's plain
    version on the port's CPU, ``online_attention`` in the reference.  One
    plain call a layer in ``encode`` and one in ``_xattend``."""
    cfg, jp, tp = _model()
    F = 2100
    assert F > tcm.CHUNK_THRESHOLD == jcm.CHUNK_THRESHOLD
    x = _frames(cfg, 8, 1, F) * 0.5
    n0 = flash_attn.PLAIN_CALLS["flash_attention"]
    enc = ted.encode(tp, cfg, torch.from_numpy(x))
    assert flash_attn.PLAIN_CALLS["flash_attention"] == n0 + cfg.enc_layers
    want = _jencode(jp, cfg, jnp.asarray(x))
    _close(enc, want, "encode at 2100 frames")
    jl = jax.tree.map(lambda a: a[0], jp["dec_layers"])
    tl = tcm.layer_list(tp, "dec_layers/", cfg.n_layers)[0]
    h = _frames(cfg, 9, 1, 5)
    jk, jv = jed._enc_kv(jl["xattn"], want)
    tk, tv = ted._enc_kv(tl["xattn"], torch.from_numpy(np.array(want)))
    _close(tk, jk, "enc k")
    n0 = flash_attn.PLAIN_CALLS["flash_attention"]
    got = ted._xattend(tl["xattn"], cfg, torch.from_numpy(h), tk, tv)
    assert flash_attn.PLAIN_CALLS["flash_attention"] == n0 + 1
    _close(got, jed._xattend(jl["xattn"], cfg, jnp.asarray(h), jk, jv),
           "_xattend at 2100 frames")


def test_decode_differs_from_decode_train_in_the_reference():
    """ROADMAP C.7: the reference's ``decode_step`` projects q and k
    without RoPE (``encdec.py:174-177``), its ``decode_train`` rotates them
    (through ``cm.attention``).  The greedy decode's logits against the
    teacher-forced ``decode_train`` over the same tokens (token 0, then the
    greedy ones): within 1e-6 of the largest logit at position 0, where the
    rotation is the identity, apart by more than 1e-2 at positions 1-4; on
    both sides, and each side as the other."""
    cfg, jp, tp = _model()
    x = _frames(cfg, 10, 2, 8)
    steps = 5
    jl, jc = _jprefill(jp, cfg, jnp.asarray(x), 8)
    tl, tc = ted.prefill(tp, cfg, torch.from_numpy(x))
    jlog, tlog, toks = [np.asarray(jl)], [tl.numpy()], [np.zeros(2, np.int32)]
    for _ in range(steps - 1):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        toks.append(tok)
        jl, jc = _jdecode(jp, cfg, jc, jnp.asarray(tok))
        tl, tc = ted.decode_step(tp, cfg, tc, torch.from_numpy(tok))
        jlog.append(np.asarray(jl))
        tlog.append(tl.numpy())
    toks = np.stack(toks, axis=1)
    jenc = _jencode(jp, cfg, jnp.asarray(x))
    jtrain = np.asarray(_jdecode_train(jp, cfg, jenc, jnp.asarray(toks)))
    ttrain = ted.decode_train(tp, cfg, ted.encode(tp, cfg,
                                                  torch.from_numpy(x)),
                              torch.from_numpy(toks)).numpy()
    _close(ttrain, jtrain, "decode_train")
    for side, dec, train in (("reference", jlog, jtrain),
                             ("port", tlog, ttrain)):
        scale = float(np.abs(train).max())
        gaps = [float(np.abs(dec[t] - train[:, t]).max()) / scale
                for t in range(steps)]
        assert gaps[0] <= 1e-6, (side, gaps)
        assert min(gaps[1:]) > 1e-2, (side, gaps)
    for t in range(steps):
        _close(tlog[t], jlog[t], f"decode position {t}")
