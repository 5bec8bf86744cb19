"""The port's dense LM (reduced ``qwen3-1.7b``) against the reference's, on
the reference's own random weights carried across with
``repro_torch.convert``: logits of ``forward`` and ``prefill`` and the
prefill cache, on the materialized-softmax branch (S <= 2048) and on the
online-softmax branch (S > 2048), at rtol = atol = 1e-4 (f32 on both sides;
the products are summed in other orders)."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import api as japi
from repro.models import common as jcm
from repro.models import dense as jdense
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import dense as tdense

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    cfg = jconfigs.get_config("qwen3-1.7b").reduced()
    jp = jdense.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return cfg, jp, tp


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def test_config_is_the_reference_config():
    jcfg = jconfigs.get_config("qwen3-1.7b")
    tcfg = tget_config("qwen3-1.7b")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.head_dim_, tcfg.d_ff, tcfg.vocab, tcfg.qk_norm,
            tcfg.param_dtype, tcfg.compute_dtype) == \
        (28, 2048, 16, 8, 128, 6144, 151936, True, "float32", "float32")
    ref = pathlib.Path(jconfigs.__file__).parent / "qwen3_1p7b.py"
    port = pathlib.Path(tcm.__file__).parents[1] / "configs" / "qwen3_1p7b.py"
    assert port.read_bytes() == ref.read_bytes()


def test_init_has_the_reference_tree(model):
    cfg, jp, tp = model
    mine = tapi.init(cfg, "cpu", torch.Generator().manual_seed(0))
    assert list(mine) == list(tp)
    for key in tp:
        assert mine[key].shape == tp[key].shape, key
        assert mine[key].dtype == torch.float32
    # layer norms start at one, projections are scaled normals
    assert torch.equal(mine["layers/ln1"], torch.ones(cfg.n_layers,
                                                      cfg.d_model))
    std = mine["layers/attn/wq"].std().item() * np.sqrt(cfg.d_model)
    assert 0.9 < std < 1.1


def test_forward_and_prefill_short_prompt(model):
    """S = 64: the materialized softmax; the cache padded to cache_len."""
    cfg, jp, tp = model
    toks = _tokens(1, 2, 64, cfg.vocab)
    want = np.asarray(jdense.forward(jp, cfg, jnp.asarray(toks)))
    got = tdense.forward(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for cache_len in (64, 80):
        jl, jc = jdense.prefill(jp, cfg, jnp.asarray(toks), cache_len)
        tl, tc = tdense.prefill(tp, cfg, torch.from_numpy(toks), cache_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for key in ("k", "v"):
            assert tuple(tc[key].shape) == jc[key].shape
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)
        assert int(tc["pos"]) == int(jc["pos"]) == 64
        assert torch.equal(tdense.last_logits(tp, cfg, torch.from_numpy(toks)),
                           tl)


def test_prefill_sliding_window_ring_cache(model):
    """A window: the masked softmax with a back-window and the last
    ``window`` positions rolled into ring order."""
    cfg, jp, tp = model
    toks = _tokens(2, 1, 40, cfg.vocab)
    jl, jc = jdense.prefill(jp, cfg, jnp.asarray(toks), 64, window=16)
    tl, tc = tdense.prefill(tp, cfg, torch.from_numpy(toks), 64, window=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    fwd = tapi.make_forward(cfg, window=16)(tp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(fwd, tl)
    assert tuple(tc["k"].shape) == jc["k"].shape == (2, 1, 16, 4, 64)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)
    with pytest.raises(ValueError, match="dense cache too small"):
        tcm.pack_cache(torch.zeros(1, 8, 2, 4), 4, 0)


def test_prefill_long_prompt_takes_the_online_softmax(model):
    """S = 2304 > CHUNK_THRESHOLD: the online-softmax branch, on the CPU the
    flash kernel's plain version, and never the (S, S) mask."""
    from repro_torch.kernels import flash_attn
    cfg, jp, tp = model
    S = 2304
    assert S > tcm.CHUNK_THRESHOLD == jcm.CHUNK_THRESHOLD
    toks = _tokens(3, 1, S, cfg.vocab)
    jl, jc = jdense.prefill(jp, cfg, jnp.asarray(toks), S)
    n0 = flash_attn.PLAIN_CALLS["flash_attention"]
    tl, tc = tapi.make_prefill(cfg, S)(tp, {"tokens": torch.from_numpy(toks)})
    assert flash_attn.PLAIN_CALLS["flash_attention"] == n0 + cfg.n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)
    fwd = tapi.make_forward(cfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(fwd, tl)


def test_common_pieces_match_reference():
    """RMSNorm over head_dim, RoPE's half-split pairing, the masks."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        tcm.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jcm.rms_norm(jnp.asarray(x), jnp.asarray(g))), **TOL)
    np.testing.assert_allclose(
        tcm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                       1e6).numpy(),
        np.asarray(jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    assert np.array_equal(tcm.causal_mask(7).numpy(),
                          np.asarray(jcm.causal_mask(7)))
    assert np.array_equal(tcm.sliding_causal_mask(7, 3).numpy(),
                          np.asarray(jcm.sliding_causal_mask(7, 3)))
    assert np.array_equal(tcm.rope_freqs(16, 1e6), jcm.rope_freqs(16, 1e6))


def test_dense_loss_is_not_ported_yet(model):
    cfg, _, _ = model
    with pytest.raises(NotImplementedError, match="loss"):
        tapi.make_loss(cfg)
    assert japi.make_loss(cfg) is not None
