"""Serving the hybrid (``zamba2-1.2b``: the reduced config and ``short``,
5 layers in groups of 2, the last group short; the reference's weights
carried across with ``convert``) in the port against the reference:

- the coded forward (``CodedServer``, code (4, 3, 1, 2), one 40-token
  prompt a subset) per schedule, with and without a straggler, against the
  reference's server (its ``make_coded_forward``) on the same parameters
  and batch, at rtol = atol = 1e-4 (``tests/test_torch_serving.py``'s
  tolerance); the port's ``make_coded_forward`` called directly on the
  placed batch gives the server's bits; each subset decodes to its own
  prompt's uncoded forward;
- ``api.cache_spec`` / ``init_cache`` against the reference's
  ``state_spec``, with and without a window;
- ``BatchedEngine.generate`` against the reference's engine: its greedy
  tokens, and every step's logits against its own prefill and decode
  executables unrolled, at 2e-4 (``tests/test_torch_decode.py``'s
  tolerance); a prompt and ``max_new`` longer than a dense ``seq_len`` are
  refused (the shared block's KV caches are positional), and served with
  a window.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.coding as jcoding
import repro.models.api as japi
import repro.serving as jserving
from repro.compat import set_mesh
from repro.configs import get_config as jget_config
from repro.core import make_code as jmake_code
from repro.launch.mesh import make_local_mesh
from repro.models import mamba_hybrid as jmh
from repro.serving import coded as jcoded
from repro.serving.engine import BatchedEngine as JEngine
from repro_torch import convert
from repro_torch import coding as tcoding
from repro_torch import serving as tserving
from repro_torch.core import make_code as tmake_code
from repro_torch.data import CodedBatcher
from repro_torch.models import api as tapi
from repro_torch.serving import coded as tcoded

torch.set_num_threads(1)

SEQ = 40
CODE = (4, 3, 1, 2)
TOL = dict(rtol=1e-4, atol=1e-4)
GEN_TOL = dict(rtol=2e-4, atol=2e-4)
CONFIGS = ["reduced", "short"]


@functools.lru_cache(maxsize=None)
def _model(which="reduced"):
    cfg = jget_config("zamba2-1.2b").reduced()
    if which == "short":
        cfg = dataclasses.replace(cfg, n_layers=5, attn_every=2)
    jp = jmh.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _prompts(B=4, S=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, _model()[0].vocab, (B, S),
                                                dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference(which, schedule):
    cfg, jp, _ = _model(which)
    srv = jserving.CodedServer(cfg, jmake_code(*CODE), make_local_mesh(4, 1),
                               jp, spec=jcoding.SchemeSpec(schedule=schedule),
                               seq_len=SEQ)
    return {st: srv.serve_batch({"tokens": _prompts()}, stragglers=st).outputs
            for st in ((), (1,))}


def _server(which="reduced", schedule="gather"):
    cfg, _, tp = _model(which)
    return tserving.CodedServer(cfg, tmake_code(*CODE), tp,
                                spec=tcoding.SchemeSpec(schedule=schedule),
                                seq_len=SEQ, device="cpu")


@pytest.mark.parametrize("which,schedule", [("reduced", "gather"),
                                            ("reduced", "a2a"),
                                            ("short", "gather")])
def test_coded_serve_matches_reference(which, schedule):
    cfg = _model(which)[0]
    srv = _server(which, schedule)
    for st in ((), (1,)):
        res = srv.serve_batch({"tokens": _prompts()}, stragglers=st)
        want = _reference(which, schedule)[st]
        assert res.outputs.shape == want.shape == (4, cfg.vocab)
        np.testing.assert_allclose(res.outputs, want, **TOL)
        assert res.failed_rows == () and res.err_bound == 0.0


@pytest.mark.parametrize("which", CONFIGS)
def test_make_coded_forward_is_the_servers_step(which):
    """``make_coded_forward`` on the placed batch: the server's bits, and
    each subset's decoded logits are its own prompt's uncoded forward."""
    cfg, _, tp = _model(which)
    code = tmake_code(*CODE)
    toks = _prompts(seed=3)
    arts = tcoded.make_coded_forward(cfg, code, seq_len=SEQ, device="cpu")
    placed = CodedBatcher(code).place({"tokens": torch.from_numpy(toks)})
    fwd = tapi.make_forward(cfg)
    own = np.concatenate([fwd(tp, {"tokens": torch.from_numpy(toks[j:j + 1])})
                          .numpy() for j in range(4)])
    srv = _server(which)
    for st in ((), (2,)):
        inp = arts.step_inputs(st)
        with torch.no_grad():
            out = arts.step(tp, placed, inp["W"], inp["mask"], inp["rho"])
        served = srv.serve_batch({"tokens": toks}, stragglers=st)
        assert np.array_equal(out.numpy(), served.outputs)
        np.testing.assert_allclose(out.numpy(), own, rtol=1e-5, atol=1e-5)


def test_subset_batch_shapes_are_the_reference_ones():
    """A hybrid subset is its tokens alone, as for the other LMs."""
    cfg = _model()[0]
    want = jcoded._subset_batch_shapes(cfg, 2, SEQ)
    got = tcoded._subset_batch_shapes(cfg, 2, SEQ)
    assert set(got) == set(want) == {"tokens"}
    assert got["tokens"][0] == want["tokens"].shape == (2, SEQ)
    assert str(got["tokens"][1]) == f"torch.{want['tokens'].dtype}"


@pytest.mark.parametrize("which", CONFIGS)
@pytest.mark.parametrize("S,window", [(40, 0), (40, 16), (7, 16)])
def test_cache_spec_is_the_reference_state_spec(which, S, window):
    cfg = _model(which)[0]
    want = convert.flatten(japi.cache_spec(cfg, 3, S, window=window))
    got = tapi.cache_spec(cfg, 3, S, window=window)
    assert list(got) == list(want) == ["conv", "k", "pos", "ssm", "v"]
    for k, (shape, dt) in got.items():
        assert shape == want[k].shape and str(dt) == f"torch.{want[k].dtype}"
    assert got["k"][0][2] == (min(S, window) if window else S)
    zero = tapi.init_cache(cfg, 3, S, window=window, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in zero.items()} == got
    assert all(not v.any() for v in zero.values())


# -------------------------------------------------------------- the engine
PROMPT, MAX_NEW = 12, 4


@functools.lru_cache(maxsize=None)
def _reference_generate(which):
    """The reference engine's greedy tokens, and each step's logits from its
    own prefill and decode executables (``generate``'s loop, unrolled)."""
    cfg, jp, _ = _model(which)
    mesh = make_local_mesh(4, 1)
    eng = JEngine(cfg, mesh, jp, batch=4, seq_len=SEQ)
    prompts = _prompts(S=PROMPT, seed=1)
    tokens = eng.generate(prompts, MAX_NEW)
    logits = []
    with set_mesh(mesh):
        lg, state = eng.arts.prefill(eng.params,
                                     {"tokens": jnp.asarray(prompts)})
        assert int(state["pos"]) == PROMPT
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        for _ in range(MAX_NEW):
            lg, state = eng.arts.decode(eng.params, state, tok)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return prompts, tokens, logits


@pytest.mark.parametrize("which", CONFIGS)
def test_generate_matches_reference_engine(which):
    cfg, _, tp = _model(which)
    prompts, want_tokens, want_logits = _reference_generate(which)
    eng = tserving.BatchedEngine(cfg, tp, batch=4, seq_len=SEQ, device="cpu")
    seen = []
    got = eng.generate(prompts, MAX_NEW, on_logits=lambda t, lg: seen.append(
        (t, lg.clone())))
    assert got.shape == (4, MAX_NEW) and got.dtype == np.int32
    assert [t for t, _ in seen] == list(range(-1, MAX_NEW))
    for (_, lg), want in zip(seen, want_logits):
        np.testing.assert_allclose(lg.numpy(), want, **GEN_TOL)
    for t in range(MAX_NEW):
        top2 = np.sort(want_logits[t], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        assert clear.sum() >= 3
        np.testing.assert_array_equal(got[clear, t], want_tokens[clear, t])


def test_generate_past_a_dense_cache_is_refused():
    """A 12-token prompt and 6 new tokens on an engine of ``seq_len = 16``:
    the shared block's dense KV caches hold 16 positions, so the port
    refuses; with a window of 8 the caches are rings and it serves."""
    cfg, _, tp = _model()
    prompts = _prompts(S=PROMPT, seed=2)
    short = tserving.BatchedEngine(cfg, tp, batch=4, seq_len=16, device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):
        short.generate(prompts, 6)
    assert short.generate(prompts, 4).shape == (4, 4)
    ring = tserving.BatchedEngine(cfg, tp, batch=4, seq_len=16, window=8,
                                  device="cpu")
    assert ring.arts.cache_shapes["k"][0][2] == 8
    assert ring.generate(prompts, 6).shape == (4, 6)
