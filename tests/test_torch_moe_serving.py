"""Serving the MoE LM (reduced ``olmoe-1b-7b``, the reference's weights
carried across with ``convert``) in the port against the reference:

- the coded forward (``CodedServer``, code (4, 3, 1, 2), 64-token prompts)
  against the reference's server, per schedule and straggler pattern, at
  rtol = atol = 1e-4 (``tests/test_torch_serving.py``'s tolerance);
- the decoded logits of each subset against the uncoded forward of that
  subset's prompts alone: the capacity counts the tokens of one forward, so
  a subset's logits are its own forward's, and on prompts that overflow
  the experts they are not those of one forward of the whole batch;
- ``BatchedEngine.generate`` against the reference's engine, every step's
  logits at 2e-4 (``tests/test_torch_decode.py``'s tolerance), on prompts
  whose decode picks collide as well as on random ones; two decodes of one
  step from clones of one cache give the same bits.

The coded forward (gather) and the engine are also held to the reference
on the einsum dispatch (``DISPATCH`` set on both sides, in chunks of
``EINSUM_CHUNK`` tokens: a 64-token prompt runs as 4 chunks).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.coding as jcoding
import repro.serving as jserving
from repro.compat import set_mesh
from repro.configs import get_config as jget_config
from repro.core import make_code as jmake_code
from repro.launch.mesh import make_local_mesh
from repro.models import moe as jmoe
from repro.serving.engine import BatchedEngine as JEngine
from repro_torch import convert
from repro_torch import coding as tcoding
from repro_torch import serving as tserving
from repro_torch.core import make_code as tmake_code
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

SEQ = 64
CODE = (4, 3, 1, 2)
TOL = dict(rtol=1e-4, atol=1e-4)
GEN_TOL = dict(rtol=2e-4, atol=2e-4)
EINSUM_CHUNK = 16


def _use_dispatch(monkeypatch, dispatch):
    for mod in (jmoe, tmoe):
        monkeypatch.setattr(mod, "DISPATCH", dispatch)
        monkeypatch.setattr(mod, "TOKEN_CHUNK", EINSUM_CHUNK)


@functools.lru_cache(maxsize=None)
def _model():
    cfg = jget_config("olmoe-1b-7b").reduced()
    jp = jmoe.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _prompts(kind, B=4, S=SEQ, seed=0):
    """``random`` tokens, or ``flooding``: prompt ``j`` is one token
    repeated, so every position of a prompt carries the same row through
    every layer and all of them pick the same experts."""
    vocab = _model()[0].vocab
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, vocab, (B, S), dtype=np.int32)
    return np.repeat(rng.integers(0, vocab, (B, 1), dtype=np.int32), S,
                     axis=1)


@functools.lru_cache(maxsize=None)
def _reference(schedule, kind, dispatch):
    """``dispatch`` keys the cache (the caller has set it on both sides)."""
    cfg, jp, _ = _model()
    srv = jserving.CodedServer(cfg, jmake_code(*CODE), make_local_mesh(4, 1),
                               jp, spec=jcoding.SchemeSpec(schedule=schedule),
                               seq_len=SEQ)
    toks = _prompts(kind)
    return {st: srv.serve_batch({"tokens": toks}, stragglers=st).outputs
            for st in ((), (1,))}


def _server(schedule="gather"):
    cfg, _, tp = _model()
    return tserving.CodedServer(cfg, tmake_code(*CODE), tp,
                                spec=tcoding.SchemeSpec(schedule=schedule),
                                seq_len=SEQ, device="cpu")


@pytest.mark.parametrize("schedule,kind,dispatch", [
    pytest.param(sch, kind, "scatter", id=f"{sch}-{kind}")
    for sch in ("gather", "a2a", "psum") for kind in ("random", "flooding")
] + [pytest.param("gather", kind, "einsum", id=f"gather-{kind}-einsum")
     for kind in ("random", "flooding")])
def test_coded_serve_matches_reference(monkeypatch, schedule, kind, dispatch):
    _use_dispatch(monkeypatch, dispatch)
    srv = _server(schedule)
    for st in ((), (1,)):
        res = srv.serve_batch({"tokens": _prompts(kind)}, stragglers=st)
        want = _reference(schedule, kind, dispatch)[st]
        assert res.outputs.shape == want.shape == (4, _model()[0].vocab)
        np.testing.assert_allclose(res.outputs, want, **TOL)
        assert res.failed_rows == () and res.err_bound == 0.0


@pytest.mark.parametrize("kind", ["random", "flooding"])
def test_each_subset_decodes_to_its_own_forward(kind):
    """One prompt a subset: the decoded logits of subset ``j`` are the
    uncoded forward of prompt ``j`` alone.  On flooding prompts a forward
    of one prompt drops its last token's picks (its 64 picks of each
    expert against ``C = 40``); in one forward of all four the first prompt
    comes first (``C = 160``) and keeps them, so that forward is not what
    a subset decodes to."""
    cfg, _, tp = _model()
    toks = _prompts(kind, seed=3)
    fwd = tapi.make_forward(cfg)
    own = np.concatenate([fwd(tp, {"tokens": torch.from_numpy(toks[j:j + 1])})
                          .numpy() for j in range(4)])
    batch = fwd(tp, {"tokens": torch.from_numpy(toks)}).numpy()
    srv = _server()
    for st in ((), (0,), (3,)):
        out = srv.serve_batch({"tokens": toks}, stragglers=st).outputs
        np.testing.assert_allclose(out, own, rtol=1e-5, atol=1e-5)
    if kind == "flooding":
        gap = float(np.abs(out - batch).max())
        assert gap > 1e-2, gap


# -------------------------------------------------------------- the engine
@functools.lru_cache(maxsize=None)
def _reference_generate(kind, max_new, dispatch):
    """The reference engine's tokens, and each step's logits from its own
    prefill and decode executables (``generate``'s loop, unrolled);
    ``dispatch`` keys the cache."""
    cfg, jp, _ = _model()
    mesh = make_local_mesh(4, 1)
    eng = JEngine(cfg, mesh, jp, batch=4, seq_len=40)
    prompts = _prompts("random", B=1 if kind == "collide" else 4, S=20,
                       seed=1)
    prompts = np.repeat(prompts, 4 // len(prompts), axis=0)
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


@pytest.mark.parametrize("kind,dispatch", [
    pytest.param(kind, dispatch, id=kind if dispatch == "scatter"
                 else f"{kind}-einsum")
    for dispatch in ("scatter", "einsum") for kind in ("random", "collide")])
def test_generate_matches_reference_engine(monkeypatch, kind, dispatch):
    """``collide``: four copies of one prompt, whose decode steps drop the
    fourth pick of each expert at ``C = 3``."""
    _use_dispatch(monkeypatch, dispatch)
    cfg, _, tp = _model()
    prompts, want_tokens, want_logits = _reference_generate(kind, 4, dispatch)
    eng = tserving.BatchedEngine(cfg, tp, batch=4, seq_len=40, device="cpu")
    seen = []
    got = eng.generate(prompts, 4, on_logits=lambda t, lg: seen.append(
        (t, lg.clone())))
    assert got.shape == (4, 4) and got.dtype == np.int32
    assert [t for t, _ in seen] == list(range(-1, 4))
    for (_, lg), want in zip(seen, want_logits):
        np.testing.assert_allclose(lg.numpy(), want, **GEN_TOL)
    for t in range(4):
        top2 = np.sort(want_logits[t], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(got[clear, t], want_tokens[clear, t])
    if kind == "collide":      # the row that lost its picks parts ways
        assert not np.allclose(want_logits[1][3], want_logits[1][0],
                               rtol=1e-4, atol=1e-4)


def test_decode_repeats_its_bits_from_clones_of_one_cache():
    cfg, _, tp = _model()
    toks = torch.from_numpy(_prompts("random", S=12, seed=2))
    arts = tserving.build_serve_artifacts(cfg, batch=4, seq_len=16,
                                          device="cpu")
    _, cache = arts.prefill(tp, {"tokens": toks})
    a, _ = arts.decode(tp, {k: v.clone() for k, v in cache.items()}, toks[:, 0])
    b, _ = arts.decode(tp, {k: v.clone() for k, v in cache.items()}, toks[:, 0])
    assert torch.equal(a, b)
    want = tapi.cache_spec(cfg, 4, 16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: s for k, (s, _) in want.items()}
