"""The port's coded server against the reference's, on reduced
``qwen3-1.7b`` (weights carried across from the reference's ``dense.init``)
at 64-token prompts: decoded last-token logits per code, schedule and
straggler pattern; then, inside the port, the contracts the reference's
``tests/test_serving_coded.py`` pins: the hedge's bitwise independence from
straggler payloads, the partial-recovery certificate and SLO verdict, failed
request rows, the request queue, and what the server refuses."""
import functools
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.coding as jcoding
import repro.serving as jserving
from repro.configs import get_config as jget_config
from repro.core import make_code as jmake_code
from repro.launch.mesh import make_local_mesh
from repro.models import dense as jdense
from repro_torch import convert
from repro_torch import coding as tcoding
from repro_torch import serving as tserving
from repro_torch.core import make_code as tmake_code
from repro_torch.data import CodedBatcher
from repro_torch.models import api as tapi

torch.set_num_threads(1)

SEQ = 64
CODES = [(4, 3, 1, 2), (4, 2, 1, 1)]
SCHEDULES = ["gather", "a2a", "psum"]
PATTERNS = [(), (1,)]
# f32 on both sides, two layers: products summed in other orders, and the
# decode's weights applied to logits of order one
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _model():
    cfg = jget_config("qwen3-1.7b").reduced()
    jp = jdense.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _prompts(code, seed=0, rows=None):
    cfg = _model()[0]
    B = code.num_subsets if rows is None else rows
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, SEQ),
                                                dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference(code_tuple, schedule):
    """The reference server's outputs for each straggler pattern (one
    compiled forward serves them all)."""
    cfg, jp, _ = _model()
    code = jmake_code(*code_tuple)
    srv = jserving.CodedServer(cfg, code, make_local_mesh(4, 1), jp,
                               spec=jcoding.SchemeSpec(schedule=schedule),
                               seq_len=SEQ)
    toks = _prompts(code)
    return {st: srv.serve_batch({"tokens": toks}, stragglers=st).outputs
            for st in PATTERNS}


def _server(code, spec=None, b=1, **kw):
    cfg, _, tp = _model()
    return tserving.CodedServer(cfg, code, tp, spec=spec, batch_per_subset=b,
                                seq_len=SEQ, device="cpu", **kw)


@pytest.mark.parametrize("stragglers", PATTERNS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("code_tuple", CODES)
def test_coded_serve_matches_reference(code_tuple, schedule, stragglers):
    code = tmake_code(*code_tuple)
    srv = _server(code, tcoding.SchemeSpec(schedule=schedule))
    res = srv.serve_batch({"tokens": _prompts(code)}, stragglers=stragglers)
    want = _reference(code_tuple, schedule)[stragglers]
    assert res.outputs.shape == want.shape == (code.num_subsets,
                                               _model()[0].vocab)
    assert res.outputs.dtype == np.float32
    np.testing.assert_allclose(res.outputs, want, **TOL)
    assert res.stragglers == stragglers and res.failed_rows == ()
    assert res.err_bound == 0.0 and res.within_slo and res.wall_s > 0


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_coded_serve_equals_uncoded_forward(schedule):
    """Every request's decoded logits are its own uncoded prefill's."""
    cfg, _, tp = _model()
    code = tmake_code(4, 3, 1, 2)
    toks = _prompts(code, seed=4)
    direct = tapi.make_forward(cfg)(tp, {"tokens": torch.from_numpy(toks)})
    srv = _server(code, tcoding.SchemeSpec(schedule=schedule))
    for st in [(), (0,), (3,)]:
        out = srv.serve_batch({"tokens": toks}, stragglers=st).outputs
        np.testing.assert_allclose(out, direct.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_hedge_is_bitwise_independent_of_straggler_payloads(schedule):
    """For every straggler set of size s, the decode under that pattern's W
    is bit-identical whether the straggler replicas' prompts are real,
    zero or garbage: waiting for the fastest n - s replicas returns the
    same bits as waiting for all n."""
    code = tmake_code(4, 3, 1, 2)
    cfg, _, tp = _model()
    arts = _server(code, tcoding.SchemeSpec(schedule=schedule)).artifacts
    toks = torch.from_numpy(_prompts(code, seed=5))
    placed = CodedBatcher(code).place({"tokens": toks})
    garbage = torch.from_numpy(_prompts(code, seed=6, rows=code.d))
    with torch.no_grad():
        for stragglers in itertools.combinations(range(code.n), code.s):
            inp = arts.step_inputs(stragglers)
            args = (inp["W"], inp["mask"], inp["rho"])
            full = arts.step(tp, placed, *args)
            for junk in (garbage, torch.zeros_like(garbage)):
                bad = {"tokens": placed["tokens"].clone()}
                for i in stragglers:
                    bad["tokens"][i] = junk[:, None]
                assert torch.equal(arts.step(tp, bad, *args), full), \
                    f"stragglers={stragglers}: a straggler payload leaked"


def test_partial_certificate_slo_and_failed_rows():
    """Past s a partial server decodes approximately, certifies the error,
    judges the SLO and names the requests whose subset lost every holder."""
    code = tmake_code(4, 2, 1, 1)     # worker i holds subsets {i, i+1 mod 4}
    srv = _server(code, tcoding.SchemeSpec(partial=True), b=2,
                  slo=tserving.ServeSLO(max_decode_err=1e-3))
    toks = _prompts(code, seed=7, rows=8)
    bounds = []
    for st in [(), (3,), (0, 1), (0, 1, 2)]:
        res = srv.serve_batch({"tokens": toks}, stragglers=st)
        bounds.append(res.err_bound)
        assert res.failed_rows == tuple(
            tserving.failed_request_rows(code, st, 2))
        assert res.within_slo == (res.err_bound <= 1e-3)
    assert bounds[0] < 1e-6 and bounds[1] < 1e-6
    assert all(hi >= lo - 1e-6 for lo, hi in zip(bounds, bounds[1:]))
    assert bounds[-1] > 1e-3
    assert srv.serve_batch({"tokens": toks}, stragglers=(0, 1)).failed_rows \
        == (2, 3)
    psum = _server(code, tcoding.SchemeSpec(schedule="psum", partial=True),
                   b=2)
    assert psum.serve_batch({"tokens": toks},
                            stragglers=(0, 1)).err_bound == 0.0


def test_failed_request_rows_equal_reference():
    for ct in CODES + [(6, 3, 2, 1)]:
        jc, tc = jmake_code(*ct), tmake_code(*ct)
        for r in range(ct[0] + 1):
            for st in itertools.combinations(range(ct[0]), r):
                assert tserving.failed_request_rows(tc, st, 3) == \
                    jserving.failed_request_rows(jc, st, 3)


def test_request_queue_pads_and_keeps_order():
    code = tmake_code(4, 3, 1, 2)
    srv = _server(code)
    toks = _prompts(code, seed=8, rows=6)
    ids = [srv.submit({"tokens": t}, arrival_s=0.5 * i)
           for i, t in enumerate(toks)]
    first, second = srv.step(), srv.step()
    assert srv.step() is None
    assert [r.req_id for r in first.requests] == ids[:4]
    assert [r.req_id for r in second.requests] == ids[4:]
    assert first.outputs.shape == (4, _model()[0].vocab)
    assert second.outputs.shape == (2, _model()[0].vocab)
    padded = np.concatenate([toks[4:], np.zeros((2, SEQ), np.int32)])
    want = srv.serve_batch({"tokens": padded}).outputs[:2]
    assert np.array_equal(second.outputs, want)

    rb = tserving.RequestBatcher(3)
    for i in range(4):
        rb.add(tserving.Request(i, {"x": np.full(2, i, np.float32)}))
    reqs, batch, valid = rb.next_batch()
    assert [r.req_id for r in reqs] == [0, 1, 2] and valid == 3
    reqs, batch, valid = rb.next_batch()
    assert valid == 1 and batch["x"].shape == (3, 2)
    assert np.array_equal(batch["x"][1:], np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="no queued requests"):
        rb.next_batch()
    rb.add(tserving.Request(9, {"x": np.zeros(2)}))
    rb.add(tserving.Request(10, {"x": np.zeros(3)}))
    with pytest.raises(ValueError, match="ragged"):
        rb.next_batch()


def test_batcher_is_a_byte_copy_of_the_reference():
    ref = pathlib.Path(jserving.__file__).parent / "batcher.py"
    port = pathlib.Path(tserving.__file__).parent / "batcher.py"
    assert port.read_bytes() == ref.read_bytes()


def test_what_is_not_ported_or_not_a_serving_lever_raises():
    from repro_torch.tune import PoissonArrivals, ServingPolicy
    code = tmake_code(4, 3, 1, 2)
    with pytest.raises(ValueError, match="autotune needs per-worker timings: "
                                         "pass a timed straggler_source"):
        _server(code, autotune=ServingPolicy(
            arrivals=PoissonArrivals(rate_rps=1.0)))
    with pytest.raises(ValueError, match="train-step levers"):
        _server(code, tcoding.SchemeSpec(pipelined=True)).artifacts
    arts = _server(code).artifacts
    inp = arts.step_inputs(())
    with pytest.raises(ValueError, match="coded"):
        arts.step(_model()[2], {"tokens": torch.zeros(4, 3, 2, SEQ)},
                  inp["W"], inp["mask"], inp["rho"])


def test_linear_family_serves_too():
    """The paper's linear workload through the same server: outputs equal
    x @ beta under a straggler."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("logistic-paper"), d_model=64)
    rng = np.random.default_rng(9)
    beta = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    code = tmake_code(4, 3, 1, 2)
    srv = tserving.CodedServer(cfg, code, {"beta": beta}, batch_per_subset=2,
                               device="cpu")
    x = rng.standard_normal((8, 64)).astype(np.float32)
    out = srv.serve_batch({"x": x}, stragglers=(2,)).outputs
    np.testing.assert_allclose(out, x @ beta.numpy(), rtol=1e-5, atol=1e-5)
    jout = jserving.CodedServer(
        dataclasses.replace(jget_config("logistic-paper"), d_model=64),
        jmake_code(4, 3, 1, 2), make_local_mesh(4, 1),
        {"beta": jnp.asarray(beta.numpy())}, batch_per_subset=2,
    ).serve_batch({"x": x}, stragglers=(2,)).outputs
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
