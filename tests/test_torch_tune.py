"""The auto-tuner in the port (``bench/straggler`` and ``tune/``) against the
reference's: the copied modules are pinned to their sources; fits, plan
rankings and the tuners' event logs are equal exactly when both sides are
fed the same ``StepRecord``s; and the autotuned entry points,
``Trainer(autotune=)`` and ``CodedServer(autotune=)``, swap codecs through
their artifact caches.  A free-running autotuned trainer ranks with its own
measured step walls, so across the two packages trajectories are compared
after the same forced ``_apply_plan`` sequence (rtol=1e-4, atol=1e-5, as in
``test_torch_step.py``)."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bench as jbench
import repro.coding as jc
import repro.core as jcore
import repro.data as jdata
import repro.optim as joptim
import repro.tune as jtune
import repro_torch.bench as tbench
import repro_torch.coding as tc
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.optim as toptim
import repro_torch.tune as ttune
from repro.configs import get_config as jget_config
from repro.core import runtime_model as jrm
from repro.launch.mesh import make_local_mesh
from repro.train import Trainer as JTrainer
from repro_torch import convert, serving as tserving
from repro_torch.configs import get_config as tget_config
from repro_torch.core import runtime_model as trm
from repro_torch.train import Trainer as TTrainer
from test_torch_families import ast_without_imports

torch.set_num_threads(1)

N = 4
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
PAPER_N8 = dict(n=8, lambda1=0.8, lambda2=0.1, t1=1.6, t2=6.0)
# the drift of the reference's trainer tests (tests/test_tune.py)
P_A = dict(n=4, lambda1=0.5, lambda2=0.2, t1=0.5, t2=16.0)
P_B = dict(n=4, lambda1=0.5, lambda2=0.2, t1=16.0, t2=0.5)


# ------------------------------------------------------------ byte pins
@pytest.mark.parametrize("rel", ["bench/straggler", "tune/telemetry",
                                 "tune/estimator", "tune/planner",
                                 "tune/policy", "tune/arrivals"])
def test_copied_module_equals_source(rel):
    ref = pathlib.Path(jtune.__file__).parents[1] / f"{rel}.py"
    port = pathlib.Path(ttune.__file__).parents[1] / f"{rel}.py"
    assert ast_without_imports(port) == ast_without_imports(ref)


def test_exports_are_the_references():
    assert ttune.__all__ == jtune.__all__
    assert set(tbench.__all__) <= set(jbench.__all__)
    assert {"draw_patterns", "mean_wait_s"} <= set(tbench.__all__)


# ------------------------------------------------------------ helpers
class _Code:
    """Minimal GradCode duck (the reference tests' ``_FakeCode``)."""

    def __init__(self, n, d, s, m, k=None, loads=None):
        self.n, self.d, self.s, self.m = n, d, s, m
        self.num_subsets = k if k is not None else n
        self.loads = tuple(loads) if loads is not None else (d,) * n


def _fit(side, params, speeds=None):
    rm = jrm if side is jtune else trm
    p = rm.RuntimeParams(**params)
    return side.FitResult(params=p, speeds=np.ones(p.n) if speeds is None
                          else np.asarray(speeds), n_steps=64, n_samples=64)


def _plans(plans):
    return [dataclasses.asdict(p) for p in plans]


def _records(side, sampler_args, codes, steps, seed, walls=None):
    """Both sides' records come from their own sampler with the same seed:
    the same draws, so the same records."""
    rm = jrm if side is jtune else trm
    params = [(s, rm.RuntimeParams(**p)) for s, p in sampler_args]
    drift = side.DriftingSampler(params, seed=seed)
    out = []
    for t in range(steps):
        code = codes[t % len(codes)]
        out.append(side.record_from_times(
            t, code, "gather", True, drift(t, code),
            measured_step_s=0.0 if walls is None else walls[t % len(walls)]))
    return out


# ------------------------------------------------------------ rankings
RANK_CASES = {
    "paper-n8": dict(schedules=("gather",), npts=8_000),
    "min-s": dict(schedules=("gather",), npts=8_000, min_s=1),
    "hetero-locked": dict(schedules=("gather",), npts=8_000,
                          families=("uniform", "hetero")),
    "hetero-forced": dict(schedules=("gather",), npts=8_000,
                          families=("hetero!",), mc_iters=50),
    "pipelined": dict(schedules=("gather",), npts=8_000,
                      pipelined_options=(False, True)),
    "stable": dict(families=(), stable_options=("rotation", "block"),
                   npts=8_000),
    "stable-gated": dict(families=(), stable_options=("rotation",),
                         max_cond=100.0, npts=8_000),
    "uniform-gated": dict(max_cond=1e6, npts=8_000),
    "approx": dict(approx_options=("frc", "expander"), max_err=3.0,
                   mc_iters=100, npts=8_000),
    "approx-departed": dict(approx_options=("frc",), max_err=3.0,
                            departed=(3,), mc_iters=100, npts=8_000),
}


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_rank_plans_equal_exactly(case):
    kw = RANK_CASES[case]
    if case == "paper-n8":
        pa, pb = PAPER_N8, PAPER_N8
    else:
        pa = pb = dict(n=8, lambda1=2.0, lambda2=1.0, t1=0.01, t2=0.05)
    a = jtune.rank_plans(_fit(jtune, pa), **kw)
    b = ttune.rank_plans(_fit(ttune, pb), **kw)
    assert a and _plans(a) == _plans(b)
    assert [p.describe() for p in a] == [p.describe() for p in b]


def test_rank_plans_with_a_cost_book_equal_exactly():
    recs = {}
    for side in (jtune, ttune):
        codes = [_Code(8, 3, 1, 2), _Code(8, 4, 2, 2), _Code(8, 2, 1, 1)]
        recs[side] = _records(side, [(0, PAPER_N8)], codes, 12, seed=4,
                              walls=[0.5, 0.0, 2.0])
        for r in recs[side][:3]:
            recs[side].append(dataclasses.replace(r, schedule="a2a",
                                                  measured_step_s=0.01))
    a = jtune.rank_plans(_fit(jtune, PAPER_N8), npts=8_000,
                         cost_book=jtune.step_cost_book(recs[jtune]))
    b = ttune.rank_plans(_fit(ttune, PAPER_N8), npts=8_000,
                         cost_book=ttune.step_cost_book(recs[ttune]))
    assert _plans(a) == _plans(b)
    assert a[0].schedule == "a2a"


def test_fits_and_crosscheck_equal_exactly():
    codes = [_Code(4, 4, 2, 2), _Code(4, 3, 1, 2), _Code(4, 1, 0, 1)]
    got = {}
    for side in (jtune, ttune):
        recs = _records(side, [(0, P_A)], codes, 300, seed=11)
        fit = side.fit_runtime_params(recs)
        got[side] = (dataclasses.asdict(fit.params), fit.speeds.tolist(),
                     fit.n_steps, fit.n_samples,
                     side.crosscheck_waits(fit, recs, npts=8_000))
    assert got[jtune] == got[ttune]
    a = jtune.synthetic_fit(jrm.RuntimeParams(**PAPER_N8), steps=200, seed=7)
    b = ttune.synthetic_fit(trm.RuntimeParams(**PAPER_N8), steps=200, seed=7)
    assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
    assert np.array_equal(a.speeds, b.speeds)


def test_straggler_patterns_equal_exactly():
    pa, pb = jrm.RuntimeParams(**PAPER_N8), trm.RuntimeParams(**PAPER_N8)
    a = jbench.draw_patterns(pa, 4, 1, 3, 20, seed=3)
    b = tbench.draw_patterns(pb, 4, 1, 3, 20, seed=3)
    assert [(p.stragglers, p.wait_s) for p in a] == \
        [(p.stragglers, p.wait_s) for p in b]
    assert jbench.mean_wait_s(a) == tbench.mean_wait_s(b)


# ------------------------------------------------------------ event logs
def _mk_plan(side, d, s, m, schedule="gather", **kw):
    return side.Plan(family=kw.pop("family", "uniform"), d=d, s=s, m=m,
                     k=kw.pop("k", N), loads=kw.pop("loads", (d,) * N),
                     schedule=schedule, packed=True, predicted_wait_s=0.0,
                     predicted_step_s=0.0, predicted_total_s=0.0, **kw)


def _drive_autotuner(side, policy_kw, start, drift, seed, steps):
    """The reference tests' control loops, on one side."""
    rm = jrm if side is jtune else trm
    policy = side.AutotunePolicy(**policy_kw)
    tuner = side.Autotuner(policy, current=_mk_plan(side, *start))
    params = [(s, rm.RuntimeParams(**p)) for s, p in drift]
    sampler = side.DriftingSampler(params, seed=seed)
    code = _Code(N, *start)
    for t in range(steps):
        tuner.record(side.record_from_times(t, code, "gather", True,
                                            sampler(t, code)))
        new = tuner.maybe_replan(t)
        if new is not None:
            # the code a trainer would build: an approx plan's drop budget
            # may exceed its code's structural s
            code = (_Code(N, new.d, new.s, new.m) if new.family == "uniform"
                    else (jcore if side is jtune else tcore).make_approx(
                        new.family, N, new.d // new.m, new.m))
    return tuner


AUTOTUNER_CASES = {
    "holds-then-switches": (
        dict(interval=5, window=10, min_samples=5, schedules=("gather",),
             npts=6_000), (4, 2, 2), [(0, P_A), (20, P_B)], 9, 40),
    "rejects-implausible-fit": (
        dict(interval=4, window=8, min_samples=4, schedules=("gather",),
             npts=4_000, max_crosscheck_rel_err=0.0),
        (4, 2, 2), [(0, P_A)], 1, 12),
    "not-due-before-min-samples": (
        dict(interval=2, window=8, min_samples=6), (3, 1, 2),
        [(0, dict(n=4, lambda1=1.0, lambda2=1.0, t1=1.0, t2=1.0))], 0, 10),
    "approx": (
        dict(interval=3, window=6, min_samples=3, schedules=("gather",),
             npts=4_000, approx_options=("frc",), max_err=3.0),
        (4, 2, 2), [(0, P_A), (6, P_B)], 3, 16),
}


@pytest.mark.parametrize("case", list(AUTOTUNER_CASES))
def test_autotuner_event_logs_equal_exactly(case):
    kw, start, drift, seed, steps = AUTOTUNER_CASES[case]
    a = _drive_autotuner(jtune, kw, start, drift, seed, steps)
    b = _drive_autotuner(ttune, kw, start, drift, seed, steps)
    assert a.events == b.events and a.events
    assert dataclasses.asdict(a.current) == dataclasses.asdict(b.current)
    if case == "holds-then-switches":
        assert any(e["switched"] for e in b.events)


def test_autotuner_rescores_a_current_plan_outside_the_search_space():
    kw = dict(interval=4, window=8, min_samples=4, schedules=("gather",),
              npts=6_000)
    logs = []
    for side in (jtune, ttune):
        tuner = side.Autotuner(side.AutotunePolicy(**kw),
                               current=_mk_plan(side, 4, 2, 2, "a2a"))
        rm = jrm if side is jtune else trm
        sampler = side.ShiftedExpSampler(rm.RuntimeParams(**P_A), seed=2)
        code = _Code(N, 4, 2, 2)
        for t in range(8):
            tuner.record(side.record_from_times(t, code, "gather", True,
                                                sampler(t, code)))
            assert tuner.maybe_replan(t) is None
        logs.append(tuner.events)
    assert logs[0] == logs[1] and logs[1]


def test_serving_planner_and_tuner_equal_exactly():
    got = []
    for side in (jtune, ttune):
        rm = jrm if side is jtune else trm
        params = rm.RuntimeParams(**P_A)
        fit = side.synthetic_fit(params, steps=64, seed=0)
        arr = side.PoissonArrivals(rate_rps=0.05)
        plans = side.rank_serving_plans(fit, arrivals=arr, batch_requests=8,
                                        wait_draws=200, n_requests=800)
        queue = side.simulate_queue([1.0] * 64, side.PoissonArrivals(
            rate_rps=20.0), batch_requests=4, seed=0)
        policy = side.ServingPolicy(arrivals=arr, interval=8, min_samples=8,
                                    wait_draws=100, n_requests=500)
        tuner = side.ServingAutotuner(policy, batch_requests=8)
        sampler = side.ShiftedExpSampler(params, seed=3)
        code = (jcore if side is jtune else tcore).make_code(4, 1, 0, 1)
        adopted = []
        for t in range(24):
            tuner.record(side.record_from_times(
                t, code, "gather", True, sampler(t, code),
                measured_step_s=0.01))
            plan = tuner.maybe_replan(t + 1)
            if plan is not None:
                adopted.append(dataclasses.asdict(plan))
                code = (jcore if side is jtune else tcore).make_code(
                    4, plan.d, plan.s, plan.m)
        got.append((_plans(plans), queue, tuner.events, adopted))
    assert got[0] == got[1]
    assert got[1][3] and got[1][3][0]["m"] > 1


# ------------------------------------------------------ the autotuned Trainer
def _cfgs(d_model=64):
    return (dataclasses.replace(jget_config("logistic-paper"), d_model=d_model),
            dataclasses.replace(tget_config("logistic-paper"), d_model=d_model))


def _port_trainer(code=(4, 4, 2, 2), **kw):
    tcfg = _cfgs()[1]
    return TTrainer(tcfg, tcore.make_code(*code),
                    toptim.get_optimizer("sgd", 1e-2), device="cpu", **kw)


def _batch(rng, n_rows=16):
    return tdata.make_synthetic_batch(rng, _cfgs()[1], n_rows, 0)


def test_trainer_autotune_swaps_codec_and_reuses_cache(monkeypatch):
    drift = ttune.DriftingSampler([(0, trm.RuntimeParams(**P_A)),
                                   (6, trm.RuntimeParams(**P_B))], seed=3)
    policy = ttune.AutotunePolicy(interval=3, window=6, min_samples=3,
                                  schedules=("gather",), npts=4_000)
    tr = _port_trainer(straggler_source=drift, autotune=policy)
    rng = np.random.default_rng(0)
    for _ in range(16):
        m = tr.step(_batch(rng))
        assert "modeled_wait_s" in m and "step_time_s" in m
    assert any(e["switched"] for e in tr.autotune_events)
    assert (tr.code.d, tr.code.s, tr.code.m) != (4, 2, 2)
    assert len(tr.telemetry) == 16
    n_arts = tr.cached_schemes
    assert n_arts >= 2
    # a swap back to the first scheme builds nothing
    from repro_torch.train import trainer as trainer_mod
    built = []
    real = trainer_mod.make_coded_train_step
    monkeypatch.setattr(trainer_mod, "make_coded_train_step",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    tr._apply_plan(_mk_plan(ttune, 4, 2, 2))
    tr.step(_batch(rng))
    assert tr.cached_schemes == n_arts and not built


def test_trainer_autotune_partial_interop():
    drift = ttune.DriftingSampler([(0, trm.RuntimeParams(**P_A)),
                                   (4, trm.RuntimeParams(**P_B))], seed=6)
    policy = ttune.AutotunePolicy(interval=3, window=6, min_samples=3,
                                  schedules=("gather",), npts=4_000)
    tr = _port_trainer(spec=tc.SchemeSpec(partial=True),
                       straggler_source=drift, autotune=policy)
    rng = np.random.default_rng(1)
    for _ in range(10):
        m = tr.step(_batch(rng))
        assert "decode_err_bound" in m and np.isfinite(m["decode_err_bound"])
    assert any(e["switched"] for e in tr.autotune_events)
    assert all(k[3] is True for k in tr._arts_cache)


def test_trainer_applies_stable_and_approx_plans():
    tr = _port_trainer()
    rng = np.random.default_rng(0)
    tr._apply_plan(_mk_plan(ttune, 3, 1, 2, family="rotation",
                            cond_bound=50.0))
    assert tr.code.kind == "rotation" and tr.code.seed == 0
    assert tr._current_plan().family == "rotation"
    assert np.isfinite(tr.step(_batch(rng))["loss"])
    tr._apply_plan(_mk_plan(ttune, 2, 1, 1, family="block", n0=2))
    assert isinstance(tr.code, tcore.BlockCompositeCode) and tr.code.n0 == 2
    assert tr._current_plan().n0 == 2
    assert np.isfinite(tr.step(_batch(rng))["loss"])
    assert not tr.partial
    frc = tcore.make_frc(N, 1, 1)
    tr._apply_plan(_mk_plan(ttune, 2, 3, 1, family="frc",
                            err_bound=frc.worst_err_bound(3)))
    assert isinstance(tr.code, tcore.FractionalRepetitionCode)
    assert tr.partial and tr.spec.partial and not tr.spec.pipelined
    assert tr._current_plan().family == "frc"
    assert np.isfinite(tr.step(_batch(rng))["loss"])
    tr._apply_plan(_mk_plan(ttune, 2, 1, 1, family="expander"))
    assert isinstance(tr.code, tcore.ExpanderCode) and tr.code.seed == 0
    assert tr._current_plan().family == "expander"


def test_trainer_autotune_requires_a_timed_source():
    with pytest.raises(ValueError, match="timed straggler_source"):
        _port_trainer(autotune=ttune.AutotunePolicy())
    with pytest.raises(ValueError, match="per-worker timings"):
        _port_trainer(autotune=ttune.AutotunePolicy(),
                      straggler_source=ttune.RandomStragglers(seed=1))


def test_trainer_records_a_fresh_signature_as_compile_time():
    """The first step under a signature (and batch shape) stands in for the
    reference's freshly compiled executable: its wall goes to
    ``compile_s``, not to the step-cost book.  Under a pipelined
    signature that first step is the fill, which retires no update."""
    sampler = ttune.ShiftedExpSampler(trm.RuntimeParams(**P_A), seed=0)
    tr = _port_trainer(code=(4, 3, 1, 2), straggler_source=sampler)
    rng = np.random.default_rng(0)
    for _ in range(3):
        tr.step(_batch(rng))
    tr._apply_plan(_mk_plan(ttune, 4, 2, 2, pipelined=True))
    for _ in range(3):
        tr.step(_batch(rng))
    recs = tr.telemetry.records
    assert [r.measured_step_s > 0 for r in recs] == [False, True, True,
                                                     False, True, True]
    assert [r.compile_s > 0 for r in recs] == [True, False, False,
                                               True, False, False]
    assert [r.pipelined for r in recs] == [False] * 3 + [True] * 3


# ---------------------------------- trajectories after forced plan sequences
def _pair(spec_kw, source, start=(4, 3, 1, 2), opt="sgd", cls=(None, None)):
    """A reference trainer and a port trainer in the same state."""
    jcfg, tcfg = _cfgs()
    jsrc, tsrc = source
    jt = (cls[0] or JTrainer)(
        jcfg, jcore.make_code(*start), make_local_mesh(N, 1),
        joptim.get_optimizer(opt, 1e-2),
        spec=jc.SchemeSpec(backend="ref", **spec_kw), straggler_source=jsrc,
        seed=0)
    tt = (cls[1] or TTrainer)(
        tcfg, tcore.make_code(*start), toptim.get_optimizer(opt, 1e-2),
        spec=tc.SchemeSpec(**spec_kw), straggler_source=tsrc, seed=0,
        device="cpu")
    beta = (0.1 * np.random.default_rng(11).standard_normal(64)).astype(
        np.float32)
    jt.params = {"beta": jnp.asarray(beta)}
    jt.opt_state = jt.optimizer.init(jt.params)
    tt.params = convert.params_from_jax({"beta": beta}, device="cpu")
    tt.opt_state = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jt.opt_state), device="cpu")
    return jt, tt


def _drift_pair():
    return tuple(side.DriftingSampler(
        [(0, rm.RuntimeParams(**P_A)), (3, rm.RuntimeParams(**P_B))],
        seed=5) for side, rm in ((jtune, jrm), (ttune, trm)))


def _hetero_loads():
    return tcore.plan_hetero((1.0,) * N, s=1, m=2, k=8).loads


def _follow(jt, tt, schedule):
    """Step both trainers; before step ``t`` apply ``schedule[t]`` (a plan
    spec) on both sides; hold metrics and parameters step by step."""
    rng = np.random.default_rng(1)
    for t, plan in enumerate(schedule):
        if plan is not None:
            args, kw = plan
            jt._apply_plan(_mk_plan(jtune, *args, **dict(kw)))
            tt._apply_plan(_mk_plan(ttune, *args, **dict(kw)))
            assert tt._scheme_sig == jt._scheme_sig
            assert tt.cached_schemes == len(jt._arts_cache)
        b = _batch(rng, 16)
        mj, mt = jt.step(b), tt.step(b)
        assert set(mt) == set(mj), t
        for k in mj:
            if k != "step_time_s":
                np.testing.assert_allclose(mt[k], mj[k], err_msg=f"{t} {k}",
                                           **TRAJ_TOL)
        np.testing.assert_allclose(tt.params["beta"].numpy(),
                                   np.asarray(jt.params["beta"]),
                                   err_msg=str(t), **TRAJ_TOL)
    assert [r.stragglers for r in tt.telemetry.records] == \
        [r.stragglers for r in jt.telemetry.records]


def test_forced_plan_sequence_follows_the_reference():
    """Uniform -> rotation -> block -> frc (flips to partial) -> hetero ->
    expander -> back to uniform, one or two steps each, under a drifting
    timed source."""
    jt, tt = _pair({}, _drift_pair())
    _follow(jt, tt, [
        None, None,
        ((3, 1, 2), {"family": "rotation"}), None,
        ((2, 1, 1), {"family": "block", "n0": 2}),
        ((2, 3, 1), {"family": "frc"}),
        ((3, 1, 2), {"family": "hetero", "k": 8,
                     "loads": _hetero_loads()}), None,
        ((2, 1, 1), {"family": "expander"}),
        ((3, 1, 2), {}), None,
    ])
    assert tt.partial and jt.partial
    assert tt.cached_schemes == len(jt._arts_cache) == 7


def test_forced_pipelined_swap_drains_and_follows_the_reference():
    """A fused pipelined trainer gets a pipelined plan while an update is in
    flight: both sides drain it under the outgoing code, then fill under
    the new one (the first step after the swap reports NaN)."""
    jt, tt = _pair(dict(pipelined=True, fuse_apply=True), _drift_pair())
    _follow(jt, tt, [None, None, None,
                     ((4, 2, 2), {"pipelined": True}), None, None,
                     ((3, 1, 2), {"pipelined": True, "schedule": "a2a"}),
                     None])
    assert tt.spec.fuse_apply and tt.pipelined and tt.schedule == "a2a"


class _JFailover(JTrainer):
    def _step_partial(self, stragglers):
        return self._step_count == 2 or bool(self.partial)


class _TFailover(TTrainer):
    def _step_partial(self, stragglers):
        return self._step_count == 2 or bool(self.partial)


def test_step_partial_hook_drains_and_steps_synchronously():
    """A subclass that forces one partial step (the elastic trainer's
    failover hook) on a pipelined trainer: the update in flight is drained
    and the step runs synchronously, as in the reference."""
    jt, tt = _pair(dict(pipelined=True), _drift_pair(),
                   cls=(_JFailover, _TFailover))
    _follow(jt, tt, [None] * 5)
    assert tt.cached_schemes == len(jt._arts_cache) == 2


# ------------------------------------------------------ the autotuned server
def _linear_server(code, **kw):
    cfg = dataclasses.replace(tget_config("logistic-paper"), d_model=64)
    beta = torch.from_numpy(
        np.random.default_rng(9).standard_normal(64).astype(np.float32))
    return cfg, beta, tserving.CodedServer(
        cfg, tcore.make_code(*code), {"beta": beta}, batch_per_subset=2,
        device="cpu", **kw)


def test_coded_server_autotune_replans_and_caches_artifacts():
    sampler = ttune.ShiftedExpSampler(trm.RuntimeParams(**P_A), seed=0)
    policy = ttune.ServingPolicy(arrivals=ttune.PoissonArrivals(rate_rps=0.05),
                                 interval=6, min_samples=6, wait_draws=100,
                                 n_requests=400)
    cfg, beta, srv = _linear_server((4, 1, 0, 1), straggler_source=sampler,
                                    autotune=policy)
    B = srv.batch_requests
    x = np.random.default_rng(0).standard_normal((B, 64)).astype(np.float32)
    for _ in range(7):
        res = srv.serve_batch({"x": x})
    assert srv.code.m > 1, "server never adopted a comm-reducing plan"
    assert srv.batch_requests == B
    assert len(srv._arts) == 2
    assert any(e["switched"] for e in srv._tuner.events)
    res = srv.serve_batch({"x": x})
    np.testing.assert_allclose(res.outputs, x @ beta.numpy(), rtol=1e-5,
                               atol=1e-5)
    # returning to the first scheme rebuilds nothing
    srv._apply_plan(dataclasses.replace(srv._tuner.current, d=1, s=0, m=1))
    srv.serve_batch({"x": x})
    assert len(srv._arts) == 2


def test_coded_server_autotune_requires_a_timed_source():
    policy = ttune.ServingPolicy(arrivals=ttune.PoissonArrivals(rate_rps=1.0))
    with pytest.raises(ValueError, match="timed straggler_source"):
        _linear_server((4, 3, 1, 2), autotune=policy)
