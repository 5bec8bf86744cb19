"""Batched generation across processes: ``BatchedEngine(..., comm=)`` on 2
``gloo`` ranks on the CPU, against the single-process engine and the
reference's.

The engine follows the reference's rule for its mesh's data axes: the
``B`` rows go over the ``P`` ranks in blocks of ``B / P`` when ``P``
divides ``B``, and every rank runs the whole batch otherwise; an MoE model
always runs whole (its capacity counts the whole batch's tokens).

- Reduced ``qwen3-1.7b``, 4 prompts, split 2 a rank: every rank returns
  the single-process engine's tokens and the reference's ``BatchedEngine``
  on a ``(2, 1)`` host mesh from the same parameters (``convert.py``); the
  logits each rank sees (its own rows) within 2e-5 of the single process's
  rows, and within ``tests/test_torch_decode.py``'s 2e-4 of the
  reference's.
- ``B = 3``, which 2 ranks do not divide: every rank runs all 3 rows,
  bitwise the single process.
- Reduced ``olmoe-1b-7b``: whole on every rank, bitwise.
- Reduced ``xlstm-350m``: split, tokens exactly and logits within 2e-5.

A rank imports this module; it imports neither JAX nor the reference at
its top.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm import make_dist_comm
from repro_torch.configs import get_config
from repro_torch.launch import ranks as tranks

torch.set_num_threads(1)

TIMEOUT = 120.0
TOL = dict(rtol=2e-5, atol=2e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-4)
SEQ_LEN = 40
PROMPT = 20
MAX_NEW = 5
# name -> (arch, batch, rows a rank on 2 ranks)
CASES = {"qwen3": ("qwen3-1.7b", 4, 2), "qwen3-b3": ("qwen3-1.7b", 3, 3),
         "olmoe": ("olmoe-1b-7b", 4, 4), "xlstm": ("xlstm-350m", 4, 2)}


def _prompts(cfg, B):
    return np.random.default_rng(5).integers(0, cfg.vocab, (B, PROMPT),
                                             dtype=np.int32)


def _params(arch, qwen3):
    """The case's parameters on the host: qwen3's from the reference's
    init (numpy, through ``convert``), the others drawn by the port from a
    seed."""
    from repro_torch import convert
    from repro_torch.models import api
    cfg = get_config(arch).reduced()
    if arch == "qwen3-1.7b":
        return cfg, convert.params_from_jax(qwen3, device="cpu")
    return cfg, api.init(cfg, "cpu", torch.Generator().manual_seed(3))


def _generate(name, qwen3, comm=None):
    """The case's tokens, the logits of every step (this process's rows)
    and the engine's split."""
    from repro_torch.serving import BatchedEngine
    arch, B, _ = CASES[name]
    cfg, params = _params(arch, qwen3)
    eng = BatchedEngine(cfg, params, batch=B, seq_len=SEQ_LEN, device="cpu",
                        comm=comm)
    seen = []
    tokens = eng.generate(
        _prompts(cfg, B), MAX_NEW,
        on_logits=lambda t, lg: seen.append(lg.clone().numpy()))
    return {"tokens": tokens, "logits": seen,
            "rows_per_rank": eng.rows_per_rank,
            "rows": (eng.rows.start, eng.rows.stop)}


def _rank_body(rank, nproc, device, qwen3):
    comm = make_dist_comm(nproc, device=device)
    return {name: _generate(name, qwen3, comm) for name in CASES}


@pytest.fixture(scope="module")
def qwen3():
    """The reference's seed-0 parameters of reduced qwen3-1.7b (numpy)."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import dense as jdense
    jp = jdense.init(jax.random.PRNGKey(0),
                     jget_config("qwen3-1.7b").reduced())
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def ranks(qwen3):
    return tranks.run_ranks(_rank_body, 2, args=(qwen3,), device="cpu",
                            backend="gloo", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def single(qwen3):
    return {name: _generate(name, qwen3) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_single_process_tokens(ranks, single, name):
    """The split the rule gives, the whole ``(B, MAX_NEW)`` tokens on every
    rank, and each rank's logits against the single process's rows: within
    2e-5 where the rows were split, bitwise where every rank ran them
    all."""
    _, B, per_rank = CASES[name]
    want = single[name]
    assert want["rows_per_rank"] == B and want["rows"] == (0, B)
    for rank, got in enumerate(ranks):
        got = got[name]
        assert got["rows_per_rank"] == per_rank
        lo = rank * per_rank if per_rank < B else 0
        assert got["rows"] == (lo, lo + per_rank)
        assert got["tokens"].shape == (B, MAX_NEW)
        assert got["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert len(got["logits"]) == MAX_NEW + 1
        for t, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            w = w[lo:lo + per_rank]
            if per_rank == B:
                assert g.tobytes() == w.tobytes(), t
            else:
                np.testing.assert_allclose(g, w, err_msg=str(t), **TOL)


def test_split_ranks_match_the_reference_engine(ranks, qwen3):
    """Reduced qwen3-1.7b on 2 ranks against the reference's
    ``BatchedEngine`` on a ``(2, 1)`` host mesh, which shards the 4 rows
    over its data axis: the tokens exactly, and each rank's logits against
    the reference's prefill and decode executables unrolled."""
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.configs import get_config as jget_config
    from repro.launch.mesh import make_local_mesh
    from repro.serving.engine import BatchedEngine as JEngine
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    cfg = jget_config("qwen3-1.7b").reduced()
    mesh = make_local_mesh(2, 1)
    eng = JEngine(cfg, mesh, qwen3, batch=4, seq_len=SEQ_LEN)
    prompts = _prompts(cfg, 4)
    want_tokens = eng.generate(prompts, MAX_NEW)
    want_logits = []
    with set_mesh(mesh):
        lg, cache = eng.arts.prefill(eng.params,
                                     {"tokens": jnp.asarray(prompts)})
        want_logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        for _ in range(MAX_NEW):
            lg, cache = eng.arts.decode(eng.params, cache, tok)
            want_logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for rank, got in enumerate(ranks):
        got = got["qwen3"]
        np.testing.assert_array_equal(got["tokens"], want_tokens)
        for t, (g, w) in enumerate(zip(got["logits"], want_logits,
                                       strict=True)):
            np.testing.assert_allclose(g, w[2 * rank:2 * rank + 2],
                                       err_msg=str(t), **REF_TOL)
