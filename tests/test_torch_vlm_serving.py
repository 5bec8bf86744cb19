"""Serving the VLM (reduced ``internvl2-26b``, the reference's weights
carried across with ``convert``) in the port against the reference:

- the coded forward (``CodedServer``, code (4, 3, 1, 2), one request a
  subset, each request its tokens and its patch embeddings) per schedule
  and straggler pattern against the last position of the reference's
  ``vlm.forward``, at rtol = atol = 1e-4 (``tests/test_torch_serving.py``'s
  tolerance), also through the request queue.  The reference's own coded
  forward cannot be the yardstick: it prefills into a cache of the tokens'
  length alone and raises for every VLM (ROADMAP C.4), which a test here
  records beside the port's answer;
- ``BatchedEngine.generate`` against the reference's engine (zero patches
  before the prompts; its prefill and decode executables unrolled, since
  its ``generate`` raises for a VLM on this JAX, ROADMAP C.5): every step's
  logits at 2e-4 (``tests/test_torch_decode.py``'s tolerance) and the
  greedy tokens; a cache that cannot hold patches, prompt and new tokens
  is refused.

Both on reduced ``internvl2-26b`` and on a variant with the card's
q_per_kv = 6 and an odd vocabulary (92553 is odd: the subset's logits fold
into ``ceil(V / m)`` rows with one pad element).
"""
import dataclasses
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
from repro.models import vlm as jvlm
from repro.serving import coded as jcoded
from repro.serving.engine import BatchedEngine as JEngine
from repro_torch import convert
from repro_torch import coding as tcoding
from repro_torch import serving as tserving
from repro_torch.core import make_code as tmake_code
from repro_torch.models import api as tapi
from repro_torch.serving import coded as tcoded

torch.set_num_threads(1)

SEQ = 40
CODE = (4, 3, 1, 2)
TOL = dict(rtol=1e-4, atol=1e-4)
GEN_TOL = dict(rtol=2e-4, atol=2e-4)
VARIANTS = ["reduced", "gqa6"]


@functools.lru_cache(maxsize=None)
def _model(variant="reduced"):
    cfg = jget_config("internvl2-26b").reduced()
    if variant == "gqa6":
        cfg = dataclasses.replace(cfg, n_heads=12, n_kv_heads=2, head_dim=32,
                                  vocab=509)
    jp = jvlm.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _requests(cfg, B=4, S=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
            "embeds": rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _reference_last(variant):
    """The last position's logits of the reference's full forward."""
    cfg, jp, _ = _model(variant)
    batch = _requests(cfg)
    return np.asarray(jvlm.forward(jp, cfg, jnp.asarray(batch["tokens"]),
                                   jnp.asarray(batch["embeds"]))[:, -1])


def _server(variant, schedule="gather"):
    cfg, _, tp = _model(variant)
    return tserving.CodedServer(cfg, tmake_code(*CODE), tp,
                                spec=tcoding.SchemeSpec(schedule=schedule),
                                seq_len=SEQ, device="cpu")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("schedule", ["gather", "a2a", "psum"])
def test_coded_serve_matches_reference_forward(variant, schedule):
    cfg = _model(variant)[0]
    srv = _server(variant, schedule)
    want = _reference_last(variant)
    for st in ((), (1,), (3,)):
        res = srv.serve_batch(_requests(cfg), stragglers=st)
        assert res.outputs.shape == want.shape == (4, cfg.vocab)
        np.testing.assert_allclose(res.outputs, want, **TOL)
        assert res.failed_rows == () and res.err_bound == 0.0


@pytest.mark.parametrize("variant", VARIANTS)
def test_requests_carry_their_patches_through_the_queue(variant):
    """``submit`` a payload of tokens and patches per request, ``step``:
    the served batch's outputs, in request order; a batch without its
    patches is refused."""
    cfg = _model(variant)[0]
    srv = _server(variant)
    batch = _requests(cfg)
    ids = [srv.submit({k: v[j] for k, v in batch.items()}) for j in range(4)]
    res = srv.step()
    assert [r.req_id for r in res.requests] == ids and srv.step() is None
    np.testing.assert_allclose(res.outputs, _reference_last(variant), **TOL)
    with pytest.raises(ValueError, match="embeds"):
        srv.serve_batch({"tokens": batch["tokens"]}, stragglers=())


def test_subset_batch_shapes_are_the_reference_ones():
    """``seq`` counts the tokens; the patches come as their own operand."""
    cfg = _model()[0]
    want = jcoded._subset_batch_shapes(cfg, 2, SEQ)
    got = tcoded._subset_batch_shapes(cfg, 2, SEQ)
    assert set(got) == set(want) == {"tokens", "embeds"}
    for k, (shape, dt) in got.items():
        assert shape == want[k].shape and str(dt) == f"torch.{want[k].dtype}"
    assert got["embeds"][0] == (2, 8, cfg.d_model)


def test_reference_coded_forward_raises_and_the_port_answers():
    """ROADMAP C.4: the reference's ``make_forward`` prefills patches and
    tokens into a cache of the tokens' length and raises; the port's
    serves the prompt with its patches: ``vlm.prefill``'s logits at
    ``cache_len = P + S``."""
    cfg, jp, tp = _model()
    batch = _requests(cfg, B=2)
    with pytest.raises(ValueError, match="dense cache too small"):
        japi.make_forward(cfg)(jp, jax.tree.map(jnp.asarray, batch))
    P = cfg.n_frontend_tokens
    want, _ = jvlm.prefill(jp, cfg, jnp.asarray(batch["tokens"]), P + SEQ,
                           embeds=jnp.asarray(batch["embeds"]))
    got = tapi.make_forward(cfg)(tp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -------------------------------------------------------------- the engine
PROMPT, MAX_NEW = 20, 4


@functools.lru_cache(maxsize=None)
def _reference_generate(variant):
    """The reference engine's greedy tokens and each step's logits, from
    its own prefill and decode executables: ``generate``'s loop unrolled,
    with its zero patches made on the host.  The reference's ``generate``
    itself raises for a VLM on this JAX: it makes the patches with
    ``jnp.zeros`` under the mesh, whose sharding its jitted prefill refuses
    (ROADMAP C.5)."""
    cfg, jp, _ = _model(variant)
    mesh = make_local_mesh(4, 1)
    seq_len = cfg.n_frontend_tokens + PROMPT + MAX_NEW
    eng = JEngine(cfg, mesh, jp, batch=4, seq_len=seq_len)
    prompts = _requests(cfg, S=PROMPT, seed=1)["tokens"]
    with pytest.raises(ValueError, match="[Ss]harding"):
        eng.generate(prompts, MAX_NEW)
    tokens, logits = [], []
    zeros = np.zeros((4, cfg.n_frontend_tokens, cfg.d_model),
                     jnp.dtype(cfg.compute_dtype))
    with set_mesh(mesh):
        batch = {"tokens": jnp.asarray(prompts), "embeds": jnp.asarray(zeros)}
        lg, cache = eng.arts.prefill(eng.params, batch)
        assert int(cache["pos"]) == cfg.n_frontend_tokens + PROMPT
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        for _ in range(MAX_NEW):
            tokens.append(np.asarray(tok))
            lg, cache = eng.arts.decode(eng.params, cache, tok)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return prompts, np.stack(tokens, axis=1), logits


@pytest.mark.parametrize("variant", VARIANTS)
def test_generate_matches_reference_engine(variant):
    cfg, _, tp = _model(variant)
    prompts, want_tokens, want_logits = _reference_generate(variant)
    eng = tserving.BatchedEngine(
        cfg, tp, batch=4, seq_len=cfg.n_frontend_tokens + PROMPT + MAX_NEW,
        device="cpu")
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


def test_generate_counts_the_patches_in_the_cache():
    """The cache holds P patches, the prompt and the new tokens: one slot
    short is refused, before any prefill runs."""
    cfg, _, tp = _model()
    P = cfg.n_frontend_tokens
    prompts = _requests(cfg, S=PROMPT, seed=2)["tokens"]
    short = tserving.BatchedEngine(cfg, tp, batch=4,
                                   seq_len=P + PROMPT + MAX_NEW - 1,
                                   device="cpu")
    with pytest.raises(ValueError, match="cannot hold 8 patches"):
        short.generate(prompts, MAX_NEW)
    # a window keeps a ring of slots: no length is refused
    ring = tserving.BatchedEngine(cfg, tp, batch=4, seq_len=16, window=16,
                                  device="cpu")
    assert ring.generate(prompts, MAX_NEW).shape == (4, MAX_NEW)
