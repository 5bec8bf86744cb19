"""Elastic training across processes: ``ElasticTrainer`` over a
``DistComm`` on the CPU under ``gloo``, and ``DistComm``'s uneven blocks.

- Every collective for ``n`` in 3, 5, 7, 8 on 2, 3 and 4 ranks (rank ``r``
  of ``P`` holds workers ``[r n // P, (r + 1) n // P)``; ``n = 3`` on 4
  ranks leaves rank 0 none), bitwise against ``LocalComm`` on the same
  inputs, with the same call and byte counts.
- ``ElasticTrainer`` on reduced ``logistic-paper`` (d_model 32) through
  every rung, on the traces of ``tests/test_torch_elastic.py`` and of
  ``chip_smoke.py``'s elastic phase: the ladder at n = 4 (a resize to 3
  leaves a rank of 4 with no worker) and n = 8, the burst, seeded Poisson
  churn, the fused pipelined re-plan with an update in flight at n = 4 and
  8, a tuner's ``resize_to`` plan (one taken, one skipped), and a tuner's
  resize and the way back with checkpoints.  On 2 and 4 ranks every rank's
  ladder log, per-step metrics, collectives' counts and bytes, codes and
  state digest are bitwise the single-process trainer's; only the root
  saves the resizes' snapshots.  Where ``tests/test_torch_elastic.py``
  holds the single-process trainer against the reference's, the ranks'
  logs and parameters are held against the reference's too.
- Ranks that disagree on a ladder decision, or on a step's stragglers,
  raise on every rank with the decision named, within the group's timeout.

A rank imports this module; it imports neither JAX nor the reference at
its top.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import coding
from repro_torch.comm import make_dist_comm, make_local_comm
from repro_torch.configs import get_config
from repro_torch.launch import ranks as tranks

torch.set_num_threads(1)

TIMEOUT = 120.0
CFG = dataclasses.replace(get_config("logistic-paper"), d_model=32)
# n of each collective case, and (shape after n, dtype) of its inputs
COLLECTIVE_N = (3, 5, 7, 8)
COLLECTIVE_SHAPES = (((6, 3), "float32"), ((2, 5), "float64"))


def _ladder(n):
    return dict(code=(n, 3, 1, 2), churn=[(3, "leave", n - 1),
                                          (9, "join", n - 1)],
                policy=dict(replan_after=1, resize_after=3,
                            prewarm=(n - 1,)), steps=14)


# name -> the trainer and its run: ``churn`` a MembershipTrace list or
# "poisson"; ``plans`` {step: resize_to} applied before that step;
# ``resize`` {step: n} a direct resize before that step
CASES = {
    "ladder-4": dict(_ladder(4), rows=12),
    "ladder-8": dict(_ladder(8), rows=56),
    "burst-8": dict(code=(8, 3, 1, 2),
                    churn=[(3, "preempt", 6), (3, "preempt", 7)],
                    policy=dict(replan_after=1, resize_after=0), steps=6,
                    rows=16),
    "poisson-4": dict(code=(4, 3, 1, 2), churn="poisson",
                      policy=dict(replan_after=1, resize_after=3), steps=16,
                      rows=12),
    "pipelined-4": dict(code=(4, 3, 1, 2), churn=[(3, "leave", 3)],
                        policy=dict(replan_after=1, resize_after=0), steps=7,
                        rows=12, spec=dict(pipelined=True, fuse_apply=True)),
    "pipelined-8": dict(code=(8, 3, 1, 2), churn=[(3, "leave", 7)],
                        policy=dict(replan_after=1, resize_after=0), steps=8,
                        rows=56, spec=dict(pipelined=True, fuse_apply=True)),
    "tuner-resize": dict(code=(4, 3, 1, 2), churn=None, policy={}, steps=6,
                         rows=12, plans={2: 3, 4: 5}),
    "tuner-resize-ckpt": dict(code=(8, 3, 1, 2), churn=None, policy={},
                              steps=3, rows=56, plans={1: 7}, resize={2: 8},
                              ckpt=True),
}
# the cases tests/test_torch_elastic.py holds against the reference, and
# the options of its trainer pairs there
REFERENCE = {"ladder-4": {}, "ladder-8": {}, "burst-8": {},
             "poisson-4": {}, "pipelined-4": {}, "tuner-resize": {}}


def _bits(t):
    t = t.detach().contiguous()
    return str(t.dtype), tuple(t.shape), t.reshape(-1).view(torch.uint8) \
        .numpy().tobytes()


def _collective_inputs(n):
    rng = np.random.default_rng(n)
    return [torch.from_numpy(rng.standard_normal((n, n * a, b)).astype(dt))
            for (a, b), dt in COLLECTIVE_SHAPES]


def _collectives(device):
    """Each collective of ``DistComm(n)`` on this rank's rows of each
    input, with the counts and bytes of the calls."""
    out = {}
    for n in COLLECTIVE_N:
        comm = make_dist_comm(n, device=device)
        got = []
        for x in _collective_inputs(n):
            comm.reset_counts()
            res = {k: _bits(getattr(comm, k)(comm.rows(x)))
                   for k in ("all_gather", "all_to_all", "psum")}
            got.append((res, dict(comm.counts), dict(comm.bytes)))
        out[n] = {"workers": (comm.workers.start, comm.workers.stop),
                  "calls": got}
    return out


def _churn(case, skew=None):
    from repro_torch.elastic import MembershipTrace, PoissonChurn
    if case["churn"] == "poisson":
        return PoissonChurn(n=4, leave_rate=0.25, join_rate=0.4, seed=9)
    trace = list(case["churn"] or []) + list(skew or [])
    return MembershipTrace(trace) if trace else None


def _trainer(case, comm, ckpt_dir=None, skew=None):
    """The case's trainer over ``comm`` (None: the single-process group),
    from the seeded beta of ``test_torch_elastic._pair``."""
    from repro_torch import convert
    from repro_torch.core import make_code
    from repro_torch.elastic import ElasticPolicy, ElasticTrainer
    from repro_torch.optim import get_optimizer
    tr = ElasticTrainer(
        CFG, make_code(*case["code"]), get_optimizer("sgd", 1e-2),
        spec=coding.SchemeSpec(**case.get("spec", {})), seed=0,
        device="cpu", comm=comm, churn=_churn(case, skew),
        elastic=ElasticPolicy(**case["policy"]),
        checkpoint_dir=ckpt_dir, checkpoint_every=0)
    beta = (0.1 * np.random.default_rng(11).standard_normal(32)).astype(
        np.float32)
    tr.params = convert.params_from_jax({"beta": beta}, device="cpu")
    tr.opt_state = tr.optimizer.init(tr.params)
    return tr


def _resize_plan(n):
    from repro_torch.tune import Plan
    return Plan(family="uniform", d=3, s=1, m=2, k=n, loads=(3,) * n,
                schedule="gather", packed=True, predicted_wait_s=0.0,
                predicted_step_s=0.0, predicted_total_s=0.0, resize_to=n)


def _run(name, comm=None, ckpt_dir=None, skew=None, force=None):
    """Run case ``name``: its ladder log, each step's metrics (bytes),
    collectives, worker block and code, the state digest, beta and the
    steps this process saved.  ``skew`` adds churn events and ``force``
    ``(step, decision)`` replaces the ladder's decision at that step, on
    this process alone."""
    from repro_torch import convert
    from repro_torch.data import make_synthetic_batch
    from repro_torch.launch.train import state_digest
    case = CASES[name]
    tr = _trainer(case, comm, ckpt_dir, skew)
    saved = []
    if tr._ckpt is not None:
        save = tr._ckpt.save
        tr._ckpt.save = lambda step, *a: saved.append(step) or save(step, *a)
    if force is not None:
        decide = tr._ladder_decision
        tr._ladder_decision = lambda step: (force[1] if step == force[0]
                                            else decide(step))
    rng = np.random.default_rng(1)
    steps = []
    for t in range(case["steps"]):
        if t in case.get("plans", {}):
            tr._apply_plan(_resize_plan(case["plans"][t]))
        if t in case.get("resize", {}):
            tr.resize(case["resize"][t])
        for comm_n, _, _ in tr._comm_caches.values():
            comm_n.reset_counts()
        tr.comm.reset_counts()
        m = tr.step(make_synthetic_batch(rng, CFG, case["rows"], 0))
        group = tr.arts.comm
        steps.append({
            "metrics": {k: np.float64(v).tobytes() for k, v in m.items()
                        if k != "step_time_s"},
            "counts": dict(group.counts), "bytes": dict(group.bytes),
            "workers": (group.workers.start, group.workers.stop),
            "n": group.n, "code": np.asarray(tr.code.C).tobytes()})
    drained = tr.drain()
    return {"events": tr.elastic_events, "steps": steps,
            "drained": None if drained is None else {
                k: np.float64(v).tobytes() for k, v in drained.items()
                if k != "step_time_s"},
            "digest": state_digest(tr.params, tr.opt_state),
            "beta": convert.params_to_numpy(tr.params)["beta"],
            "saved": saved}


def _raised(fn):
    try:
        fn()
    except Exception as e:                   # noqa: BLE001 - reported
        return type(e).__name__, str(e)
    return None, ""


def _group_body(rank, nproc, device, ckpt_dir, trainers):
    """One rank: the collectives, then (``trainers``) every case over a
    ``DistComm`` and the two disagreements (a case's failure is reported,
    not raised, so the other cases still count)."""
    import traceback
    out = {"collectives": _collectives(device), "cases": {}}
    if not trainers:
        return out
    for name, case in CASES.items():
        try:
            out["cases"][name] = _run(
                name, make_dist_comm(case["code"][0], device=device),
                ckpt_dir=ckpt_dir if case.get("ckpt") else None)
        except Exception:                    # noqa: BLE001 - reported
            out["cases"][name] = traceback.format_exc()
    comm = make_dist_comm(4, device=device)
    out["disagree"] = {
        "ladder": _raised(lambda: _run(
            "ladder-4", comm, force=(2, ("resize", 3, None)) if rank == 1
            else None)),
        "stragglers": _raised(lambda: _run(
            "ladder-4", comm, skew=[(1, "leave", 0)] if rank == 1
            else None))}
    return out


def _group(nproc, tmp_path_factory, trainers=True):
    ckpt = str(tmp_path_factory.mktemp(f"elastic{nproc}"))
    res = tranks.run_ranks(_group_body, nproc, args=(ckpt, trainers),
                           device="cpu", backend="gloo", timeout=TIMEOUT)
    return {"ranks": res, "ckpt": ckpt}


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    return _group(2, tmp_path_factory)


@pytest.fixture(scope="module")
def group3(tmp_path_factory):
    return _group(3, tmp_path_factory, trainers=False)


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    return _group(4, tmp_path_factory)


@pytest.fixture
def group(request):
    return request.getfixturevalue(f"group{request.param}")


@pytest.fixture(scope="module")
def local(tmp_path_factory):
    """Each case's single-process run (``LocalComm``)."""
    ckpt = str(tmp_path_factory.mktemp("elastic_local"))
    return {name: _run(name, ckpt_dir=ckpt if case.get("ckpt") else None)
            for name, case in CASES.items()}


# ------------------------------------------------------------- collectives
@pytest.mark.parametrize("n", COLLECTIVE_N)
@pytest.mark.parametrize("group", [2, 3, 4], indirect=True)
def test_uneven_collectives_are_bitwise_localcomm(group, n):
    ranks = group["ranks"]
    P = len(ranks)
    blocks = []
    for rank, res in enumerate(ranks):
        got = res["collectives"][n]
        lo, hi = rank * n // P, (rank + 1) * n // P
        assert got["workers"] == (lo, hi)
        blocks.append(hi - lo)
        for x, (calls, counts, nbytes) in zip(_collective_inputs(n),
                                              got["calls"], strict=True):
            local = make_local_comm(n, "cpu")
            assert calls["all_gather"] == _bits(local.all_gather(x))
            assert calls["all_to_all"] == _bits(local.all_to_all(x)[lo:hi])
            assert calls["psum"] == _bits(local.psum(x))
            assert counts == local.counts == {"all_gather": 1,
                                              "all_to_all": 1, "psum": 1}
            assert nbytes == local.bytes
    assert sum(blocks) == n and max(blocks) - min(blocks) <= 1
    assert (0 in blocks) == (n < P)


# ------------------------------------------------------------- the trainer
def _case(res, name):
    got = res["cases"][name]
    assert isinstance(got, dict), got        # else the rank's traceback
    return got


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("group", [2, 4], indirect=True)
def test_elastic_ranks_are_bitwise_the_single_process(group, local, name):
    """Every rank's ladder log, metrics, collectives, codes, drained
    update and state are the single-process run's, bit for bit; each step
    ran on the rank's block of the step's worker count."""
    want = local[name]
    ranks = group["ranks"]
    P = len(ranks)
    for rank, res in enumerate(ranks):
        got = _case(res, name)
        assert got["events"] == want["events"]
        assert got["digest"] == want["digest"]
        assert got["drained"] == want["drained"]
        assert np.array_equal(got["beta"], want["beta"])
        for t, (g, w) in enumerate(zip(got["steps"], want["steps"],
                                       strict=True)):
            assert g["metrics"] == w["metrics"], t
            assert (g["counts"], g["bytes"]) == (w["counts"], w["bytes"]), t
            assert g["code"] == w["code"] and g["n"] == w["n"], t
            n = w["n"]
            assert g["workers"] == (rank * n // P, (rank + 1) * n // P), t
    assert len({s["n"] for s in want["steps"]}) > 1 or name in (
        "burst-8", "pipelined-4", "pipelined-8")


def test_the_ladders_resize_into_an_empty_block(group4, local):
    """On 4 ranks the n = 4 ladder's resize to 3 leaves rank 0 with no
    worker for three steps; it still gathered, decoded and applied the
    update with the others."""
    steps = _case(group4["ranks"][0], "ladder-4")["steps"]
    empty = [t for t, s in enumerate(steps) if s["workers"][0] == s["workers"][1]]
    assert empty == [6, 7, 8]
    assert all(s["counts"]["all_gather"] >= 1 for s in steps)


def test_only_the_root_saves_the_resizes_snapshots(group2, group4, local):
    """A tuner's resize to 7 and the return to 8 checkpoint before and
    after each swap: the root rank saved them all, no other rank any, and
    the single process the same steps."""
    want = local["tuner-resize-ckpt"]["saved"]
    assert want == [1, 1, 2, 2]
    for g in (group2, group4):
        saved = [_case(r, "tuner-resize-ckpt")["saved"] for r in g["ranks"]]
        assert saved[0] == want and not any(saved[1:])
        names = sorted(p.name for p in pathlib.Path(g["ckpt"]).iterdir())
        assert names == ["ckpt_00000001.npz", "ckpt_00000002.npz"]


@pytest.mark.parametrize("name", list(REFERENCE))
def test_ranks_follow_the_reference(group2, name):
    """The 2-rank trainer against the reference's ``ElasticTrainer`` on
    host meshes, as ``tests/test_torch_elastic.py`` holds the
    single-process one: the ladder log exactly, beta at its tolerance."""
    import jax
    import test_torch_elastic as te
    case = CASES[name]
    n = case["code"][0]
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")

    def churn(el):
        if case["churn"] == "poisson":
            return el.PoissonChurn(n=4, leave_rate=0.25, join_rate=0.4,
                                   seed=9)
        return el.MembershipTrace(case["churn"]) if case["churn"] else None

    spec = dict(case.get("spec", {}))
    port_kw = ({"fuse_apply": spec.pop("fuse_apply")}
               if "fuse_apply" in spec else None)
    jt, _ = te._pair(case["code"], churn, case["policy"], spec_kw=spec,
                     port_kw=port_kw)
    rng = np.random.default_rng(1)
    for t in range(case["steps"]):
        if t in case.get("plans", {}):
            jt._apply_plan(te._resize_plan(te.jtune, case["plans"][t]))
        jt.step(make_batch(rng, case["rows"]))
    for res in group2["ranks"]:
        got = _case(res, name)
        assert got["events"] == jt.elastic_events
        np.testing.assert_allclose(got["beta"], np.asarray(jt.params["beta"]),
                                   **te.TRAJ_TOL)


def make_batch(rng, rows):
    from repro_torch.data import make_synthetic_batch
    return make_synthetic_batch(rng, CFG, rows, 0)


# ------------------------------------------------------------- disagreement
@pytest.mark.parametrize("what,words", [
    ("ladder", "the elastic ladder's decision at step 2"),
    ("stragglers", "the stragglers and the partial failover at step 1")])
@pytest.mark.parametrize("group", [2, 4], indirect=True)
def test_ranks_that_disagree_raise(group, what, words):
    for res in group["ranks"]:
        kind, msg = res["disagree"][what]
        assert kind == "RuntimeError", msg
        assert f"the ranks disagree on {words}" in msg, msg
        assert "rank 0: " in msg and "rank 1: " in msg
