"""Elastic membership in the port (``repro_torch.elastic``) against the
reference's ``repro.elastic``: the copied modules are pinned to their
sources; every case of ``tests/test_elastic.py`` runs on the port; and the
port's ``ElasticTrainer`` follows the reference's on the same churn traces:
the ladder's decision log and every code and decode weight equal exactly,
the parameters at rtol=1e-4 / atol=1e-5 (as ``test_torch_step.py``'s
trajectories: f32 on both sides, terms added in other orders).

The reference runs on host meshes (``tests/conftest.py`` forces 8 devices)
on its plain backend; the port on the CPU.  Its trainers compile per scheme
and cluster size, so each trace is one pair of trainers.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.coding as jc
import repro.core as jcore
import repro.elastic as jel
import repro.optim as joptim
import repro.train.trainer as jtrainer_mod
import repro.tune as jtune
import repro_torch.coding as tc
import repro_torch.elastic as tel
import repro_torch.train.trainer as ttrainer_mod
import repro_torch.tune as ttune
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import make_code, plan_hetero
from repro_torch.core.runtime_model import RuntimeParams
from repro_torch.data import make_synthetic_batch
from repro_torch.elastic import (ACTIVE, DEPARTED, SUSPECTED, ElasticPolicy,
                                 ElasticTrainer, MembershipEvent,
                                 MembershipSource, MembershipTrace,
                                 MembershipTracker, NoChurn, PoissonChurn,
                                 as_churn_source)
from repro_torch.optim import get_optimizer
from repro_torch.tune import (FixedStragglers, StepRecord, rank_plans,
                              score_plan, step_cost_book, synthetic_fit)
from test_torch_families import ast_without_imports

torch.set_num_threads(1)

CFG = dataclasses.replace(get_config("logistic-paper"), d_model=32)
BATCH = 12          # divisible by 4 and 3: both cluster sizes split evenly
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


def _trainer(code=None, churn=None, policy=None, **kw):
    code = code or make_code(4, 3, 1, 2)
    return ElasticTrainer(CFG, code, get_optimizer("sgd", 1e-2), churn=churn,
                          elastic=policy or ElasticPolicy(), seed=0,
                          device="cpu", **kw)


def _batch(rng, rows=BATCH):
    return make_synthetic_batch(rng, CFG, rows, 0)


# ------------------------------------------------------------ byte pins
@pytest.mark.parametrize("name", ["events", "tracker"])
def test_copied_module_equals_source(name):
    ref = pathlib.Path(jel.__file__).parent / f"{name}.py"
    port = pathlib.Path(tel.__file__).parent / f"{name}.py"
    assert ast_without_imports(port) == ast_without_imports(ref)


def _class_ast(path, name):
    tree = ast.parse(pathlib.Path(path).read_text())
    node, = [n for n in tree.body
             if isinstance(n, ast.ClassDef) and n.name == name]
    return ast.dump(node, include_attributes=False)


def test_elastic_policy_equals_source():
    ref = pathlib.Path(jel.__file__).parent / "trainer.py"
    port = pathlib.Path(tel.__file__).parent / "trainer.py"
    assert _class_ast(port, "ElasticPolicy") == _class_ast(ref,
                                                           "ElasticPolicy")


def test_elastic_exports_the_references_names():
    assert tel.__all__ == jel.__all__


# --------------------------------------------------------------- events
def test_membership_event_validation():
    MembershipEvent(step=0, kind="leave", worker=1)
    with pytest.raises(ValueError):
        MembershipEvent(step=0, kind="explode", worker=1)
    with pytest.raises(ValueError):
        MembershipEvent(step=0, kind="join", worker=-1)


def test_membership_trace_replays_in_step_order():
    tr = MembershipTrace([(5, "leave", 2), (1, "join", 0), (5, "join", 3)])
    assert [e.worker for e in tr.events(1)] == [0]
    assert sorted(e.worker for e in tr.events(5)) == [2, 3]
    assert tr.events(2) == ()


def test_poisson_churn_is_seed_deterministic():
    a = PoissonChurn(n=6, leave_rate=0.3, join_rate=0.3, seed=9)
    b = PoissonChurn(n=6, leave_rate=0.3, join_rate=0.3, seed=9)
    evs_a = [e for s in range(40) for e in a.events(s)]
    evs_b = [e for s in range(40) for e in b.events(s)]
    assert evs_a == evs_b
    assert all(e.kind in ("join", "leave", "preempt") for e in evs_a)
    # and the reference's sampler draws the same stream
    c = jel.PoissonChurn(n=6, leave_rate=0.3, join_rate=0.3, seed=9)
    evs_c = [e for s in range(40) for e in c.events(s)]
    assert [dataclasses.astuple(e) for e in evs_a] == \
        [dataclasses.astuple(e) for e in evs_c]


def test_as_churn_source_coercions():
    assert isinstance(as_churn_source(None), NoChurn)
    assert as_churn_source(None).events(0) == ()
    src = MembershipTrace([(0, "leave", 1)])
    assert as_churn_source(src) is src
    lst = as_churn_source([(2, "preempt", 0)])
    assert [e.kind for e in lst.events(2)] == ["preempt"]
    with pytest.raises(TypeError):
        as_churn_source(3)


# -------------------------------------------------------------- tracker
def test_tracker_explicit_leave_and_rejoin():
    t = MembershipTracker(4)
    t.apply(MembershipEvent(step=3, kind="leave", worker=2))
    assert t.departed == (2,)
    assert t.n_alive == 3
    assert t.state_of(2) == DEPARTED
    assert t.departed_for(2, step=7) == 4
    t.apply(MembershipEvent(step=8, kind="join", worker=2))
    assert t.departed == ()
    assert t.state_of(2) == ACTIVE
    assert t.departed_for(2, step=9) == 0


def test_tracker_pending_join_for_unknown_worker():
    t = MembershipTracker(4)
    t.apply(MembershipEvent(step=0, kind="join", worker=7))
    assert t.pending_joins == {7}
    assert t.departed == ()


def test_tracker_heartbeat_escalation():
    t = MembershipTracker(3, suspect_after=2, evict_after=1)
    t.observe([0], step=0)
    assert t.state_of(0) == ACTIVE          # one miss: still active
    t.observe([0], step=1)
    assert t.state_of(0) == SUSPECTED       # suspect_after=2 reached
    t.observe([0], step=2)
    assert t.state_of(0) == DEPARTED        # suspect_after + evict_after
    assert t.departed == (0,)


def test_tracker_backoff_lengthens_grace_after_eviction():
    t = MembershipTracker(2, suspect_after=1, evict_after=1, backoff=2.0)
    t.observe([1], 0)
    t.observe([1], 1)
    assert t.state_of(1) == DEPARTED        # misses 2 >= 1 + 1*2^0
    t.apply(MembershipEvent(step=2, kind="join", worker=1))
    t.observe([1], 3)
    t.observe([1], 4)
    assert t.state_of(1) == SUSPECTED       # threshold now 1 + 1*2^1 = 3
    t.observe([1], 5)
    assert t.state_of(1) == DEPARTED


def test_tracker_response_resets_escalation():
    t = MembershipTracker(2, suspect_after=2, evict_after=2)
    t.observe([0], 0)
    t.observe([0], 1)
    assert t.state_of(0) == SUSPECTED
    t.observe([], 2)                        # a heartbeat arrives
    assert t.state_of(0) == ACTIVE
    t.observe([0], 3)
    assert t.state_of(0) == ACTIVE          # counter restarted from zero


def test_tracker_resize_and_reactivate():
    t = MembershipTracker(4, suspect_after=1, evict_after=1)
    t.observe([3], 0)
    t.observe([3], 1)
    assert t.state_of(3) == DEPARTED
    assert t._workers[3].evictions == 1
    t.resize(3, step=2)                     # shrink: index 3 drops out
    assert t.n == 3 and t.departed == ()
    t.resize(5, step=3)                     # grow: fresh active workers
    assert t.n == 5 and t.state_of(4) == ACTIVE
    t.apply(MembershipEvent(step=4, kind="leave", worker=0))
    t.reactivate_all(step=5)                # post-repack: everyone active
    assert t.departed == () and t.state_of(0) == ACTIVE


def test_membership_source_merges_departed_into_draws():
    t = MembershipTracker(4)
    t.apply(MembershipEvent(step=0, kind="leave", worker=3))
    src = MembershipSource(t, FixedStragglers([1]))
    code = make_code(4, 3, 1, 2)
    d = src.draw(0, code)
    assert d.stragglers == (1, 3)
    # the inner draw feeds escalation: worker 1 accrues misses
    assert t._workers[1].misses > 0
    assert not src.provides_times


# --------------------------------------------------- ladder: rungs 1 & 2
def test_rung1_departed_is_forced_straggler():
    tr = _trainer(churn=[(1, "leave", 3)],
                  policy=ElasticPolicy(replan_after=0, resize_after=0))
    rng = np.random.default_rng(0)
    losses = [tr.step(_batch(rng))["loss"] for _ in range(3)]
    assert tr.tracker.departed == (3,)
    assert not tr._degraded                 # code untouched on rung 1
    assert np.isfinite(losses).all()


def test_rung2_replan_then_recover_home():
    tr = _trainer(churn=[(1, "leave", 3), (4, "join", 3)],
                  policy=ElasticPolicy(replan_after=1, resize_after=0))
    home_C = np.asarray(tr.code.C).copy()
    rng = np.random.default_rng(0)
    for _ in range(3):
        tr.step(_batch(rng))
    # after the departure outlives replan_after: zero-load exact re-plan
    assert tr._degraded
    assert tr.code.loads[3] == 0
    # the budget wants hole + original noise (2) but feasibility clamps
    # it: s + m replicas of every subset must fit on the 3 alive workers
    assert tr.code.s == 1
    for _ in range(3):
        tr.step(_batch(rng))
    # the rejoin heals every departure: back on the bitwise home scheme
    assert not tr._degraded
    np.testing.assert_array_equal(np.asarray(tr.code.C), home_C)
    actions = [e["action"] for e in tr.elastic_events]
    assert "replan-degraded" in actions and "recover-home" in actions


def test_partial_failover_past_budget():
    # two departures against s=1, and no n=4 re-plan can absorb them
    # (zero-loading 2 of 4 workers leaves no room for s+m replicas): the
    # trainer must keep taking certified approximate steps, not raise
    tr = _trainer(churn=[(1, "preempt", 2), (1, "preempt", 3)],
                  policy=ElasticPolicy(replan_after=1, resize_after=0))
    rng = np.random.default_rng(0)
    logs = [tr.step(_batch(rng)) for _ in range(4)]
    assert np.isfinite([m["loss"] for m in logs]).all()
    assert any(e["action"] == "partial-failover"
               for e in tr.elastic_events)
    assert all(np.isfinite(m["decode_err_bound"]) for m in logs[1:])


# ------------------------------------------------------- ladder: rung 3
def test_resize_preserves_params_bitwise():
    tr = _trainer()
    rng = np.random.default_rng(0)
    tr.step(_batch(rng))
    before = {k: v.clone() for k, v in tr.params.items()}
    ptrs = {k: v.data_ptr() for k, v in tr.params.items()}
    state = {k: v.clone() for k, v in tr.opt_state["mu"].items()}
    tr.resize(3)
    assert tr.code.n == 3 and tr.comm.n == 3 and tr.arts.comm.n == 3
    for k, v in tr.params.items():
        assert torch.equal(v.view(torch.int32), before[k].view(torch.int32))
        assert v.data_ptr() == ptrs[k]          # not even a copy
    for k, v in tr.opt_state["mu"].items():
        assert torch.equal(v, state[k])
    # resizing back re-instantiates the bitwise-identical home design
    tr.resize(4)
    np.testing.assert_array_equal(np.asarray(tr.code.C),
                                  np.asarray(make_code(4, 3, 1, 2).C))
    assert tr.comm.n == 4


def test_rung3_resize_down_then_scale_up():
    tr = _trainer(churn=[(1, "leave", 3), (5, "join", 9)],
                  policy=ElasticPolicy(replan_after=0, resize_after=1,
                                       prewarm=(3,)))
    rng = np.random.default_rng(0)
    for _ in range(4):
        tr.step(_batch(rng))
    assert tr.code.n == 3                   # shrunk to n_alive
    assert tr.tracker.n == 3
    for _ in range(3):
        tr.step(_batch(rng))
    assert tr.code.n == 4                   # scale-up on the pending join
    np.testing.assert_array_equal(np.asarray(tr.code.C),
                                  np.asarray(make_code(4, 3, 1, 2).C))
    resizes = [e for e in tr.elastic_events if e["action"] == "resize"]
    assert [e["n"] for e in resizes] == [3, 4]
    assert resizes[0]["warm"]               # prewarm made the 3-group warm


def test_resize_infeasible_batch_split_is_skipped():
    # global batch 12 cannot split over n=5, so a 5th pending join must
    # not trigger a resize
    tr = _trainer(churn=[(1, "join", 9)],
                  policy=ElasticPolicy(scale_up=True))
    rng = np.random.default_rng(0)
    for _ in range(3):
        tr.step(_batch(rng))
    assert tr.code.n == 4
    assert tr.tracker.pending_joins == {9}


def test_resize_checkpoints_before_and_after(tmp_path):
    tr = _trainer(checkpoint_dir=str(tmp_path), checkpoint_every=0)
    rng = np.random.default_rng(0)
    tr.step(_batch(rng))
    saved = []
    save = tr._ckpt.save
    tr._ckpt.save = lambda step, *a, **kw: (saved.append(step),
                                            save(step, *a, **kw))
    tr.resize(3)
    assert tr._ckpt.steps()                 # forced snapshots landed
    assert saved == [1, 1]                  # one before, one after


# ------------------------------------- membership-aware planner (no jit)
PARAMS = RuntimeParams(n=4, lambda1=0.5, lambda2=0.2, t1=0.5, t2=8.0)


def test_rank_plans_departed_offers_zero_load_candidate():
    fit = synthetic_fit(PARAMS, steps=120, seed=0)
    plans = rank_plans(fit, schedules=("gather",), npts=2000, mc_iters=120,
                       departed=(3,))
    hetero = [p for p in plans if p.family == "hetero"]
    assert hetero and all(p.loads[3] == 0 for p in hetero)
    assert all(np.isfinite(p.predicted_total_s) for p in plans)


def test_rank_plans_resize_candidates_are_marked():
    fit = synthetic_fit(PARAMS, steps=120, seed=0)
    plans = rank_plans(fit, schedules=("gather",), npts=2000, mc_iters=120,
                       departed=(3,), resize_options=(3,))
    resized = [p for p in plans if p.resize_to == 3]
    assert resized and all(len(p.loads) == 3 for p in resized)
    assert "resize->3" in resized[0].describe()


def test_rank_plans_classic_path_unchanged_by_elastic_args():
    fit = synthetic_fit(PARAMS, steps=120, seed=0)
    a = rank_plans(fit, schedules=("gather",), npts=2000)
    b = rank_plans(fit, schedules=("gather",), npts=2000, departed=(),
                   resize_options=(), replan_horizon=50)
    assert [(p.d, p.s, p.m, p.predicted_total_s) for p in a] == \
           [(p.d, p.s, p.m, p.predicted_total_s) for p in b]


def test_score_plan_uncoverable_budget_prices_inf():
    fit = synthetic_fit(PARAMS, steps=120, seed=0)
    plans = rank_plans(fit, schedules=("gather",), npts=2000)
    p10 = next(p for p in plans if (p.s, p.family) == (0, "uniform"))
    scored = score_plan(fit, p10, mc_iters=60, departed=(2,))
    assert not np.isfinite(scored.predicted_total_s)


def test_amortized_compile_charges_unmeasured_schemes_only():
    recs = [StepRecord(step=0, d=3, s=1, m=2, k=4, loads=(3,) * 4,
                       schedule="gather", packed=True,
                       compute_s=np.ones(4), comm_s=np.ones(4),
                       measured_step_s=0.05, compile_s=6.0)]
    book = step_cost_book(recs)
    assert book.amortized_compile(3, 4, (3,) * 4, "gather", True) == 0.0
    charge = book.amortized_compile(2, 4, (2,) * 4, "gather", True,
                                    horizon=60)
    assert charge == pytest.approx(6.0 / 60)


def test_plan_hetero_departed_infeasible_raises():
    with pytest.raises(ValueError):
        plan_hetero([1.0] * 4, s=1, m=2, departed=(2, 3))


# ------------------------------ the port's ElasticTrainer vs the reference
def _pair(start, churn, policy_kw, spec_kw=None, opt="sgd", port_kw=None):
    """The reference's ElasticTrainer and the port's in the same state
    (the port's weights carried over from a seeded numpy draw);
    ``port_kw`` adds levers on the port's side only."""
    spec_kw = spec_kw or {}
    jcfg = dataclasses.replace(jget_config("logistic-paper"), d_model=32)
    jt = jel.ElasticTrainer(
        jcfg, jcore.make_code(*start), make_local_mesh(start[0], 1),
        joptim.get_optimizer(opt, 1e-2),
        spec=jc.SchemeSpec(backend="ref", **spec_kw), seed=0,
        churn=churn(jel), elastic=jel.ElasticPolicy(**policy_kw))
    tt = ElasticTrainer(
        CFG, make_code(*start), get_optimizer(opt, 1e-2),
        spec=tc.SchemeSpec(**spec_kw, **(port_kw or {})), seed=0,
        device="cpu",
        churn=churn(tel), elastic=ElasticPolicy(**policy_kw))
    beta = (0.1 * np.random.default_rng(11).standard_normal(32)).astype(
        np.float32)
    jt.params = {"beta": jnp.asarray(beta)}
    jt.opt_state = jt.optimizer.init(jt.params)
    tt.params = convert.params_from_jax({"beta": beta}, device="cpu")
    tt.opt_state = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jt.opt_state), device="cpu")
    return jt, tt


@pytest.fixture
def step_inputs(monkeypatch):
    """Every step's host-side decode inputs, per package."""
    seen = {"jax": [], "torch": []}
    for side, mod in (("jax", jtrainer_mod), ("torch", ttrainer_mod)):
        def rec(code, stragglers=(), *a, _orig=mod.make_step_inputs,
                _side=side, **kw):
            out = _orig(code, stragglers, *a, **kw)
            seen[_side].append((np.asarray(code.C).copy(),
                                tuple(int(i) for i in stragglers),
                                {k: np.asarray(v).copy()
                                 for k, v in out.items()}))
            return out
        monkeypatch.setattr(mod, "make_step_inputs", rec)
    return seen


def _follow(jt, tt, steps, rows=BATCH, before=None):
    """Step both trainers on the same batches; hold the ladder's log, the
    active code and the parameters after every step."""
    rng = np.random.default_rng(1)
    logs = []
    for t in range(steps):
        if before is not None:
            before(t, jt, tt)
        b = make_synthetic_batch(rng, CFG, rows, 0)
        mj, mt = jt.step(b), tt.step(b)
        logs.append(mt)
        assert tt.elastic_events == jt.elastic_events, t
        assert tt._code_key(tt.code) == jt._code_key(jt.code), t
        np.testing.assert_array_equal(np.asarray(tt.code.C),
                                      np.asarray(jt.code.C), err_msg=str(t))
        assert (tt.code.n, tt.tracker.n, tt.tracker.departed) == \
            (jt.code.n, jt.tracker.n, jt.tracker.departed)
        assert tt._scheme_sig == jt._scheme_sig, t
        assert set(mt) - {"step_time_s"} == set(mj) - {"step_time_s"}, t
        for k in mj:
            if k != "step_time_s" and np.isfinite(mj[k]):
                np.testing.assert_allclose(mt[k], mj[k], err_msg=f"{t} {k}",
                                           **TRAJ_TOL)
        np.testing.assert_allclose(tt.params["beta"].numpy(),
                                   np.asarray(jt.params["beta"]),
                                   err_msg=str(t), **TRAJ_TOL)
    return logs


def _same_inputs(seen):
    assert len(seen["torch"]) == len(seen["jax"]) > 0
    for (cj, sj, ij), (ct, st, it) in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(ct, cj)
        assert st == sj
        assert set(it) == set(ij)
        for k in ij:
            np.testing.assert_array_equal(it[k], ij[k], err_msg=k)


@pytest.mark.parametrize("n,rows", [(4, BATCH), (8, 56)])
def test_ladder_follows_the_reference(step_inputs, n, rows):
    """The chip's phase (a) (at n = 8 its very trace, 56 = 8 * 7 rows): the
    last worker leaves at step 3 and rejoins at step 9; the trainer
    re-plans, resizes to the prewarmed n - 1 and returns to n."""
    jt, tt = _pair((n, 3, 1, 2),
                   lambda el: el.MembershipTrace([(3, "leave", n - 1),
                                                  (9, "join", n - 1)]),
                   dict(replan_after=1, resize_after=3, prewarm=(n - 1,)))
    _follow(jt, tt, 14, rows=rows)
    _same_inputs(step_inputs)
    assert [(e["step"], e["action"], e.get("n")) for e in tt.elastic_events] \
        == [(0, "prewarm", n - 1), (4, "replan-degraded", None),
            (6, "resize", n - 1), (9, "resize", n)]
    if n == 8:
        assert tt.elastic_events[1]["loads"] == (5, 5, 5, 5, 4, 4, 4, 0)
    np.testing.assert_array_equal(tt.code.C, make_code(n, 3, 1, 2).C)


def test_burst_follows_the_reference(step_inputs):
    """The chip's phase (b): two preemptions at once against s = 1 fail
    over to partial decode for one step, then re-plan to a zero-load code
    with s = 3 at unchanged n = 8."""
    jt, tt = _pair((8, 3, 1, 2),
                   lambda el: el.MembershipTrace([(3, "preempt", 6),
                                                  (3, "preempt", 7)]),
                   dict(replan_after=1, resize_after=0))
    logs = _follow(jt, tt, 6, rows=16)
    _same_inputs(step_inputs)
    ev = tt.elastic_events
    assert [(e["step"], e["action"]) for e in ev] == [
        (3, "partial-failover"), (4, "replan-degraded")]
    assert ev[1]["loads"] == (7, 7, 7, 7, 6, 6, 0, 0) and ev[1]["s"] == 3
    assert np.isfinite(logs[3]["decode_err_bound"])
    assert all("decode_err_bound" not in m for m in logs[4:])


def test_poisson_churn_follows_the_reference(step_inputs):
    """Seeded random churn: departures, rejoins, re-plans and resizes
    wherever the seed puts them."""
    jt, tt = _pair((4, 3, 1, 2),
                   lambda el: el.PoissonChurn(n=4, leave_rate=0.25,
                                              join_rate=0.4, seed=9),
                   dict(replan_after=1, resize_after=3))
    _follow(jt, tt, 16)
    _same_inputs(step_inputs)
    assert {e["action"] for e in tt.elastic_events} == {
        "partial-failover", "replan-degraded", "resize", "recover-home"}


@pytest.mark.parametrize("fuse", [False, True])
def test_pipelined_degrade_drains_and_follows_the_reference(step_inputs,
                                                            fuse):
    """A pipelined trainer re-plans while an update is in flight: the swap
    drains it under the outgoing code, and the degraded code runs
    synchronously, as in the reference.  The reference cannot degrade a
    fused trainer (its swap keeps ``fuse_apply`` on a synchronous spec,
    which the spec refuses), so the port's fused trainer follows the
    reference's unfused one: the fused update is the same arithmetic."""
    drains = []

    def before(t, jt, tt):
        if t == 4:
            assert tt._driver is not None and tt._driver.in_flight
            drain = tt._driver.drain
            tt._driver.drain = lambda *a: (drains.append(t), drain(*a))[1]

    jt, tt = _pair((4, 3, 1, 2),
                   lambda el: el.MembershipTrace([(3, "leave", 3)]),
                   dict(replan_after=1, resize_after=0),
                   spec_kw=dict(pipelined=True),
                   port_kw=dict(fuse_apply=True) if fuse else None)
    assert bool(tt.arts.fuse_apply) == fuse
    _follow(jt, tt, 7, before=before)
    _same_inputs(step_inputs)
    assert drains == [4]
    assert not tt.pipelined and tt._driver is None
    assert tt.spec.fuse_apply is None
    assert [e["action"] for e in tt.elastic_events] == ["replan-degraded"]


def _resize_plan(side, n):
    return side.Plan(family="uniform", d=3, s=1, m=2, k=n, loads=(3,) * n,
                     schedule="gather", packed=True, predicted_wait_s=0.0,
                     predicted_step_s=0.0, predicted_total_s=0.0,
                     resize_to=n)


def test_forced_resize_plan_follows_the_reference(step_inputs):
    """A tuner plan with ``resize_to`` goes through resize; one whose size
    does not split the batch is logged as skipped."""
    def before(t, jt, tt):
        if t in (2, 4):
            n = 3 if t == 2 else 5
            jt._apply_plan(_resize_plan(jtune, n))
            tt._apply_plan(_resize_plan(ttune, n))

    jt, tt = _pair((4, 3, 1, 2), lambda el: None, {})
    _follow(jt, tt, 6, before=before)
    _same_inputs(step_inputs)
    assert tt.elastic_events == [
        {"step": 2, "action": "resize", "n": 3, "warm": True},
        {"step": 4, "action": "resize-skipped", "to": 5,
         "reason": "infeasible"}]
    assert tt.code.n == 3


def _timed_source():
    """A timed straggler source for any cluster size (a shifted-exponential
    sampler per size)."""
    samplers = {}

    def inject(step, code):
        if code.n not in samplers:
            samplers[code.n] = ttune.ShiftedExpSampler(RuntimeParams(
                n=code.n, lambda1=0.5, lambda2=0.2, t1=0.5, t2=4.0), seed=0)
        return samplers[code.n](step, code)
    return ttune.TimedSource(inject)


def test_prewarm_builds_as_get_arts_builds():
    """A pipelined fused trainer prewarms a synchronous build: the build
    drops ``fuse_apply``, as ``_get_arts`` does, instead of raising."""
    tr = _trainer(policy=ElasticPolicy(prewarm=(3, 4, 2)),
                  spec=tc.SchemeSpec(pipelined=True, fuse_apply=True))
    assert [e["n"] for e in tr.elastic_events] == [3]
    comm3, cache3, _ = tr._comm_caches[3]
    (key, arts), = cache3.items()
    assert comm3.n == 3 and arts.comm is comm3 and not arts.pipelined
    assert key == (tr._code_key(make_code(3, 3, 1, 2)), "gather", True,
                   False, False)
    assert tr.comm.n == 4 and tr.cached_schemes == 1


def test_prewarmed_resize_builds_nothing_and_is_not_fresh():
    """A resize to a prewarmed size builds nothing and its first step
    charges no compile time; a size never prewarmed builds and is fresh.
    A return to a size stepped before is warm either way."""
    rng = np.random.default_rng(0)
    fresh = {}
    for prewarm in ((3,), ()):
        tr = _trainer(policy=ElasticPolicy(prewarm=prewarm),
                      straggler_source=_timed_source())
        tr.step(_batch(rng))
        tr.resize(3)
        built = len(tr._comm_caches[3][1])
        tr.step(_batch(rng))
        tr.step(_batch(rng))
        tr.resize(4)
        assert tr.cached_schemes == 1       # the home artifacts, reused
        tr.step(_batch(rng))
        fresh[prewarm] = ([r.compile_s > 0 for r in tr.telemetry.records],
                          built)
    assert fresh[(3,)] == ([True, False, False, False], 1)
    assert fresh[()] == ([True, True, False, False], 1)


def test_elastic_trainer_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticTrainer(CFG, make_code(4, 3, 1, 2), get_optimizer("sgd", 1e-2))
