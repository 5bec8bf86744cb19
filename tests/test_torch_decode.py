"""KV-cache decoding in the port against the reference, on reduced
``qwen3-1.7b`` with the reference's weights carried across by ``convert``:
``attention_decode`` (dense cache and ring cache, before and past the wrap)
at rtol = atol = 2e-5, ``cache_spec``, ``decode_step`` logits from the same
prefill cache and the port's own prefill -> decode against ``forward`` at
2e-4 (the tolerance of ``tests/test_models_math.py``), and
``BatchedEngine.generate`` against the reference's engine, step by step.
Then, inside the port: the cache is consumed in place, a single query row
never reaches the flash attention path, and the engine's edges."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.models import api as japi
from repro.models import common as jcm
from repro.models import dense as jdense
from repro.serving.engine import BatchedEngine as JEngine
from repro_torch import convert
from repro_torch.kernels import flash_attn
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import dense as tdense
from repro_torch.serving import (BatchedEngine, ServeArtifacts,
                                 build_serve_artifacts)

torch.set_num_threads(1)

ATT_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
WINDOW = 16


@functools.lru_cache(maxsize=None)
def _model():
    cfg = jget_config("qwen3-1.7b").reduced()
    jp = jdense.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _tokens(seed, B, S):
    cfg = _model()[0]
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# --------------------------------------------------------- attention_decode
@pytest.mark.parametrize("window,S,pos", [(0, 24, 0), (0, 24, 9), (0, 24, 23),
                                          (WINDOW, WINDOW, 3),
                                          (WINDOW, WINDOW, 15),
                                          (WINDOW, WINDOW, 16),
                                          (WINDOW, WINDOW, 29)])
def test_attention_decode_matches_reference(window, S, pos):
    cfg, jp, tp = _model()
    rng = np.random.default_rng(pos + 100 * window)
    B, Hkv, hd = 2, cfg.n_kv_heads, cfg.head_dim_
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    tattn = tcm.layer_list(tp, "layers/", cfg.n_layers)[1]["attn"]
    want = jcm.attention_decode(jattn, cfg, jnp.asarray(x), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(pos, jnp.int32),
                                window=window)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tcm.attention_decode(tattn, cfg, torch.from_numpy(x), tk, tv,
                               torch.tensor(pos, dtype=torch.int32),
                               window=window)
    assert got[1] is tk and got[2] is tv       # written in place
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **ATT_TOL)


@pytest.mark.parametrize("window", [0, WINDOW])
def test_cache_spec_matches_reference(window):
    cfg = _model()[0]
    want = japi.cache_spec(cfg, 3, 40, window=window)
    got = tapi.cache_spec(cfg, 3, 40, window=window)
    assert set(got) == set(want)
    for k, (shape, dtype) in got.items():
        assert shape == tuple(want[k].shape), k
        assert str(dtype).replace("torch.", "") == str(want[k].dtype), k
    cache = tapi.init_cache(cfg, 3, 40, window=window, device="cpu")
    for k, (shape, dtype) in got.items():
        assert cache[k].shape == shape and cache[k].dtype == dtype
        assert not cache[k].any()
    arts = build_serve_artifacts(cfg, batch=3, seq_len=40, window=window,
                                 device="cpu")
    assert isinstance(arts, ServeArtifacts) and arts.cache_shapes == got
    assert arts.device == torch.device("cpu")


# -------------------------------------------------------------- decode_step
@pytest.mark.parametrize("window", [0, WINDOW])
def test_decode_step_matches_reference_from_the_same_cache(window):
    """Both sides decode 6 forced tokens from the reference's prefill cache
    (a 20-token prompt: the ring wraps inside the prompt and again while
    decoding); logits at every step and the final cache at 2e-4."""
    cfg, jp, tp = _model()
    toks = _tokens(3, 2, 26)
    _, jcache = jdense.prefill(jp, cfg, jnp.asarray(toks[:, :20]), 32,
                               window=window)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    assert tcache["pos"].dtype == torch.int32 and int(tcache["pos"]) == 20
    for t in range(20, 26):
        jl, jcache = jdense.decode_step(jp, cfg, jcache,
                                        jnp.asarray(toks[:, t]), window=window)
        tl, tcache = tdense.decode_step(tp, cfg, tcache,
                                        torch.from_numpy(toks[:, t]),
                                        window=window)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 26
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)


def test_prefill_decode_matches_forward():
    """``tests/test_models_math.py``'s prefill + decode against the
    training forward, on the port alone."""
    cfg, _, tp = _model()
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(1, B, S))
    full = tdense.forward(tp, cfg, toks)
    logits_p, cache = tdense.prefill(tp, cfg, toks[:, :S - 2], S + 4)
    np.testing.assert_allclose(logits_p.numpy(), full[:, S - 3].numpy(),
                               **TOL)
    lg, cache = tdense.decode_step(tp, cfg, cache, toks[:, S - 2])
    np.testing.assert_allclose(lg.numpy(), full[:, S - 2].numpy(), **TOL)
    lg, cache = tdense.decode_step(tp, cfg, cache, toks[:, S - 1])
    np.testing.assert_allclose(lg.numpy(), full[:, S - 1].numpy(), **TOL)


def test_decode_consumes_the_cache_and_never_reaches_flash():
    cfg, _, tp = _model()
    toks = torch.from_numpy(_tokens(5, 2, 8))
    _, cache = tdense.prefill(tp, cfg, toks, 12)
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    before = k.clone()
    plain = flash_attn.PLAIN_CALLS["flash_attention"]
    step = tapi.make_decode(cfg)
    _, out = step(tp, cache, toks[:, 0])
    assert out["k"] is k and out["v"] is v       # the same tensors back
    assert int(out["pos"]) == int(pos) + 1 and int(pos) == 8
    assert torch.equal(k[:, :, :8], before[:, :, :8])
    assert k[:, :, 8].abs().sum() > 0 and not before[:, :, 8].any()
    assert flash_attn.PLAIN_CALLS["flash_attention"] == plain


# -------------------------------------------------------------- the engine
@functools.lru_cache(maxsize=None)
def _reference_generate(window, max_new):
    """The reference engine's tokens, and each step's logits from its own
    prefill and decode executables (``generate``'s loop, unrolled)."""
    cfg, jp, _ = _model()
    mesh = make_local_mesh(4, 1)
    eng = JEngine(cfg, mesh, jp, batch=4, seq_len=40, window=window)
    prompts = _tokens(0, 4, 20)
    tokens = eng.generate(prompts, max_new)
    logits = []
    with set_mesh(mesh):
        lg, cache = eng.arts.prefill(eng.params,
                                     {"tokens": jnp.asarray(prompts)})
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        for _ in range(max_new):
            lg, cache = eng.arts.decode(eng.params, cache, tok)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return prompts, tokens, logits


@pytest.mark.parametrize("window", [0, WINDOW])
def test_generate_matches_reference_engine(window):
    cfg, _, tp = _model()
    prompts, want_tokens, want_logits = _reference_generate(window, 5)
    eng = BatchedEngine(cfg, tp, batch=4, seq_len=40, window=window,
                        device="cpu")
    seen = []
    got = eng.generate(prompts, 5, on_logits=lambda t, lg: seen.append(
        (t, lg.clone())))
    assert got.shape == (4, 5) and got.dtype == np.int32
    assert [t for t, _ in seen] == list(range(-1, 5))
    for (_, lg), want in zip(seen, want_logits):
        np.testing.assert_allclose(lg.numpy(), want, **TOL)
    # greedy tokens agree wherever the reference's choice is clear
    for t in range(5):
        top2 = np.sort(want_logits[t], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(got[clear, t], want_tokens[clear, t])


def test_generate_batch_of_three():
    cfg, _, tp = _model()
    eng = BatchedEngine(cfg, tp, batch=3, seq_len=32, device="cpu")
    out = eng.generate(_tokens(2, 3, 8), max_new=3)
    assert out.shape == (3, 3)
    assert (out >= 0).all() and (out < cfg.vocab).all()


@pytest.mark.parametrize("window", [0, WINDOW])
def test_generate_deterministic_across_batch_slots(window):
    cfg, _, tp = _model()
    eng = BatchedEngine(cfg, tp, batch=4, seq_len=32, window=window,
                        device="cpu")
    prompts = np.repeat(_tokens(1, 1, 8), 4, axis=0)
    out = eng.generate(prompts, max_new=4)
    for b in range(1, 4):
        np.testing.assert_array_equal(out[0], out[b])


def test_engine_edges():
    cfg, _, tp = _model()
    eng = BatchedEngine(cfg, tp, batch=2, seq_len=16, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        eng.generate(_tokens(0, 3, 8), 2)
    with pytest.raises(ValueError, match="cannot hold"):
        eng.generate(_tokens(0, 2, 12), 5)
    assert eng.generate(_tokens(0, 2, 12), 0).shape == (2, 0)
    ring = BatchedEngine(cfg, tp, batch=2, seq_len=16, window=8, device="cpu")
    assert ring.generate(_tokens(0, 2, 12), 6).shape == (2, 6)


def test_engine_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg, _, tp = _model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedEngine(cfg, tp, batch=2, seq_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serve_artifacts(cfg, batch=2, seq_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_cache(cfg, 2, 16)


def test_families_without_a_cache_raise():
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("logistic-paper"), d_model=8)
    with pytest.raises(NotImplementedError, match="decode"):
        tapi.make_decode(cfg)
    with pytest.raises(NotImplementedError, match="decode"):
        tapi.cache_spec(cfg, 2, 16)
