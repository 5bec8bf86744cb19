"""Serving the encoder-decoder (reduced ``whisper-tiny``, the reference's
weights carried across with ``convert``) in the port against the
reference:

- the coded forward (``CodedServer``, code (4, 3, 1, 2), one request of 8
  frame embeddings a subset, ``{"embeds": (F, D)}`` its only operand) per
  schedule and straggler pattern against the reference's ``prefill``
  logits of each request alone, at rtol = atol = 1e-4
  (``tests/test_torch_serving.py``'s tolerance), also through the request
  queue; the hedge: a straggler's payload never reaches the output bits,
  and stragglers (1,) decode within that tolerance of none;
- ``api.make_forward`` against the reference's;
- ``BatchedEngine.generate`` against the reference's engine (``seq_len``
  zero frames; its prefill and decode executables unrolled, with the
  frames made on the host, since its ``generate`` raises for an
  encoder-decoder on this JAX, ROADMAP C.5, which a test records): every
  step's logits at 2e-4 (``tests/test_torch_decode.py``'s tolerance) and
  the greedy tokens over 70 steps, past ``dec_ctx = 64`` (the self-KV ring
  wraps; no length is refused).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.api as japi
from repro.compat import set_mesh
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.models import encdec as jed
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

FRAMES = 8
CODE = (4, 3, 1, 2)
TOL = dict(rtol=1e-4, atol=1e-4)
GEN_TOL = dict(rtol=2e-4, atol=2e-4)
_jprefill = jax.jit(jed.prefill, static_argnums=(1, 3))


@functools.lru_cache(maxsize=None)
def _model():
    cfg = jget_config("whisper-tiny").reduced()
    jp = jed.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _requests(B=4, F=FRAMES, seed=0):
    cfg = _model()[0]
    return {"embeds": np.random.default_rng(seed).standard_normal(
        (B, F, cfg.d_model)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _reference_logits():
    """The reference's ``prefill`` logits of each request alone."""
    cfg, jp, _ = _model()
    x = _requests()["embeds"]
    return np.concatenate([np.asarray(_jprefill(jp, cfg, jnp.asarray(
        x[j:j + 1]), FRAMES)[0]) for j in range(len(x))])


def _server(schedule="gather"):
    cfg, _, tp = _model()
    return tserving.CodedServer(cfg, tmake_code(*CODE), tp,
                                spec=tcoding.SchemeSpec(schedule=schedule),
                                seq_len=FRAMES, device="cpu")


@pytest.mark.parametrize("schedule", ["gather", "a2a", "psum"])
def test_coded_serve_matches_reference_prefill(schedule):
    cfg = _model()[0]
    srv = _server(schedule)
    want = _reference_logits()
    for st in ((), (1,), (3,)):
        res = srv.serve_batch(_requests(), stragglers=st)
        assert res.outputs.shape == want.shape == (4, cfg.vocab)
        np.testing.assert_allclose(res.outputs, want, **TOL)
        assert res.failed_rows == () and res.err_bound == 0.0


def test_requests_carry_their_frames_through_the_queue():
    """``submit`` one ``{"embeds": (F, D)}`` payload a request, ``step``:
    the served batch's outputs, in request order; a batch of tokens is
    refused."""
    srv = _server()
    batch = _requests()
    ids = [srv.submit({"embeds": batch["embeds"][j]}) for j in range(4)]
    res = srv.step()
    assert [r.req_id for r in res.requests] == ids and srv.step() is None
    np.testing.assert_allclose(res.outputs, _reference_logits(), **TOL)
    with pytest.raises(ValueError, match="embeds"):
        srv.serve_batch({"tokens": np.zeros((4, FRAMES), np.int32)},
                        stragglers=())


def test_hedge_straggler_payload_never_reaches_the_outputs():
    """Under stragglers (1,) the straggler's frames replaced by others give
    the same bits; stragglers (1,) and () decode within the tolerance."""
    cfg, _, tp = _model()
    srv = _server()
    batch = _requests()
    hedged = srv.serve_batch(batch, stragglers=(1,))
    code = srv.artifacts.codec.code
    placed = CodedBatcher(code).place({"embeds": torch.from_numpy(
        batch["embeds"])})
    placed["embeds"][1] = torch.from_numpy(
        _requests(B=code.d, seed=9)["embeds"][:, None])
    inp = srv.artifacts.step_inputs((1,))
    with torch.no_grad():
        junk = srv.artifacts.step(tp, placed, inp["W"], inp["mask"],
                                  inp["rho"])
    np.testing.assert_array_equal(junk.numpy(), hedged.outputs)
    full = srv.serve_batch(batch, stragglers=())
    np.testing.assert_allclose(hedged.outputs, full.outputs, **TOL)


def test_subset_batch_shapes_are_the_reference_ones():
    """``seq`` counts frames, the only operand."""
    cfg = _model()[0]
    want = jcoded._subset_batch_shapes(cfg, 2, 30)
    got = tcoded._subset_batch_shapes(cfg, 2, 30)
    assert set(got) == set(want) == {"embeds"}
    shape, dt = got["embeds"]
    assert shape == want["embeds"].shape == (2, 30, cfg.d_model)
    assert str(dt) == f"torch.{want['embeds'].dtype}"


def test_make_forward_matches_reference():
    """The per-request forward coded serving replicates: the prefill's
    logits, the cache dropped, on both sides."""
    cfg, jp, tp = _model()
    x = _requests(B=2, F=12, seed=3)
    want = jax.jit(japi.make_forward(cfg))(jp, {"embeds": jnp.asarray(
        x["embeds"])})
    got = tapi.make_forward(cfg)(tp, {"embeds": torch.from_numpy(
        x["embeds"])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -------------------------------------------------------------- the engine
PROMPT, MAX_NEW = 20, 70


@functools.lru_cache(maxsize=None)
def _reference_engine():
    cfg, jp, _ = _model()
    return JEngine(cfg, make_local_mesh(4, 1), jp, batch=4, seq_len=FRAMES)


def test_reference_engine_raises_for_encdec():
    """ROADMAP C.5, extended to the encoder-decoder: the reference's
    ``generate`` makes its zero frames with ``jnp.zeros`` under the mesh,
    whose sharding its jitted prefill refuses."""
    prompts = np.zeros((4, PROMPT), np.int32)
    with pytest.raises(ValueError, match="[Ss]harding"):
        _reference_engine().generate(prompts, 2)


@functools.lru_cache(maxsize=None)
def _reference_generate():
    """The reference engine's greedy tokens and each step's logits, from
    its own prefill and decode executables: ``generate``'s loop unrolled,
    with its ``seq_len`` zero frames made on the host."""
    cfg, _, _ = _model()
    eng = _reference_engine()
    zeros = np.zeros((4, FRAMES, cfg.d_model), jnp.dtype(cfg.compute_dtype))
    tokens, logits = [], []
    with set_mesh(eng.mesh):
        lg, cache = eng.arts.prefill(eng.params,
                                     {"embeds": jnp.asarray(zeros)})
        assert int(cache["pos"]) == 1
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        for _ in range(MAX_NEW):
            tokens.append(np.asarray(tok))
            lg, cache = eng.arts.decode(eng.params, cache, tok)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return np.stack(tokens, axis=1), logits


def test_generate_matches_reference_engine():
    cfg, _, tp = _model()
    want_tokens, want_logits = _reference_generate()
    assert MAX_NEW > cfg.dec_ctx
    eng = tserving.BatchedEngine(cfg, tp, batch=4, seq_len=FRAMES,
                                 device="cpu")
    seen = []
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (4, PROMPT),
                                                dtype=np.int32)
    got = eng.generate(prompts, MAX_NEW, on_logits=lambda t, lg: seen.append(
        (t, lg.clone())))
    assert got.shape == (4, MAX_NEW) and got.dtype == np.int32
    assert [t for t, _ in seen] == list(range(-1, MAX_NEW))
    for (t, lg), want in zip(seen, want_logits):
        np.testing.assert_allclose(lg.numpy(), want, err_msg=f"step {t}",
                                   **GEN_TOL)
    n_clear = 0
    for t in range(MAX_NEW):
        top2 = np.sort(want_logits[t], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        n_clear += int(clear.sum())
        np.testing.assert_array_equal(got[clear, t], want_tokens[clear, t])
    assert n_clear >= 0.9 * got.size


def test_generate_reads_only_the_batch_from_the_prompts():
    """The prompts fix only the batch: any prompt length, and any
    ``max_new`` past ``seq_len`` frames, gives the same tokens; a batch of
    another size is refused."""
    cfg, _, tp = _model()
    eng = tserving.BatchedEngine(cfg, tp, batch=4, seq_len=FRAMES,
                                 device="cpu")
    a = eng.generate(np.zeros((4, 3), np.int32), 12)
    b = eng.generate(np.ones((4, 50), np.int32), 12)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="slots"):
        eng.generate(np.zeros((3, 3), np.int32), 2)
