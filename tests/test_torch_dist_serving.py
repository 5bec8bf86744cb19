"""Coded serving, the tuners and checkpoints across processes, on the CPU
under ``gloo``: ranks started by ``repro_torch.launch.ranks.run_ranks`` (one
group for each group size, reused by every case; a join timeout of 120 s),
each computing only its own replicas or workers.

- ``make_coded_forward`` and ``CodedServer.serve_batch`` on
  ``logistic-paper`` (d_model 64, code (8, 4, 2, 2), a random nonzero
  ``beta``) and on reduced ``qwen3-1.7b`` (code (4, 3, 1, 2), S = 64), for 2
  and 4 ranks: ``gather``, ``a2a`` and ``psum``, with no straggler, one
  straggler and a ``partial`` spec past ``s``; the hedge (a straggler's
  payload replaced by garbage) through the forward itself.  Each rank's
  outputs, ``err_bound``, ``failed_rows`` and the collectives' counts and
  bytes are bitwise those of the single-process ``LocalComm`` run.
- An autotuned ``CodedServer`` (a ``ShiftedExpSampler``) and an autotuned
  ``Trainer`` (a ``DriftingSampler``), re-planning every 3 batches or
  steps: every rank adopts the same plans at the same batches and steps and
  ends with the same outputs or state digest; with the clock patched so
  that every wall is the same, the plans, tuner events and state are also
  the single-process run's.  A rank that adopts another plan makes every
  rank raise, naming both plans.
- ``Trainer(checkpoint_dir=, checkpoint_every=)`` on 2 ranks: only the root
  rank saves, ``keep`` holds; a fresh group resumes from the snapshot, and
  its state after the remaining steps is bitwise an uninterrupted 2-rank
  run's and the single-process run's; ranks that restore different steps
  raise.

Everything a rank runs is in this file or in the package; this module
imports neither JAX nor the reference.
"""
import dataclasses
import pathlib
import shutil
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import coding
from repro_torch.comm import make_dist_comm, make_local_comm
from repro_torch.configs import get_config
from repro_torch.launch import ranks as tranks

torch.set_num_threads(1)

TIMEOUT = 120.0
LOGISTIC = dataclasses.replace(get_config("logistic-paper"), d_model=64)
LM = get_config("qwen3-1.7b").reduced()
SEQ = 64
# model: (cfg, code, requests a subset, one straggler, a pattern past s)
MODELS = {"logistic": (LOGISTIC, (8, 4, 2, 2), 2, (5,), (0, 1, 2, 3)),
          "qwen3": (LM, (4, 3, 1, 2), 1, (1,), (0, 1, 2))}
SCHEDULES = ("gather", "a2a", "psum")
# (schedule, pattern, partial): each schedule with no straggler, one
# straggler, and past s under a partial spec
SERVE_CASES = [(sched, pat, pat == "past_s")
               for sched in SCHEDULES for pat in ("none", "one", "past_s")]
CASE_IDS = [f"{model}-{sched}-{pat}" for model in MODELS
            for sched, pat, _ in SERVE_CASES]
# the tuners' runs
P_A = dict(n=4, lambda1=0.5, lambda2=0.2, t1=0.5, t2=16.0)
P_B = dict(n=4, lambda1=0.5, lambda2=0.2, t1=16.0, t2=0.5)
TUNED_BATCHES = 9
TUNED_STEPS = 12
# the checkpointed runs: 6 steps in all, a snapshot every 2
CKPT_STEPS, CKPT_EVERY, CKPT_CUT = 6, 2, 4


def _bits(t):
    """A tensor or array as (dtype, shape, bytes): equal when bitwise."""
    a = np.ascontiguousarray(t.detach().cpu().numpy()
                             if isinstance(t, torch.Tensor) else t)
    return str(a.dtype), a.shape, a.tobytes()


# ------------------------------------------------------------- serving
def _model(name):
    """(cfg, code, b, params, one batch of requests) of a serving model,
    from seeds: every process builds the same."""
    from repro_torch.core import make_code
    from repro_torch.models import api as model_api
    cfg, code, b, _, _ = MODELS[name]
    code = make_code(*code)
    rng = np.random.default_rng(3)
    B = code.num_subsets * b
    if cfg.family == "linear":
        # random and nonzero: api.init's zero beta makes exactness vacuous
        params = {"beta": torch.from_numpy(
            rng.standard_normal(cfg.d_model).astype(np.float32))}
        batch = {"x": rng.standard_normal((B, cfg.d_model)).astype(
            np.float32)}
    else:
        params = model_api.init(cfg, "cpu", torch.Generator().manual_seed(0))
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, SEQ),
                                        dtype=np.int32)}
    return cfg, code, b, params, batch


def _pattern(name, pat):
    one, past = MODELS[name][3], MODELS[name][4]
    return {"none": (), "one": one, "past_s": past}[pat]


def _serve_cases(comm_for):
    """Every serving case on the group ``comm_for(n)`` gives: {case id:
    what it returned}, with the collectives' counts and bytes."""
    from repro_torch.data import CodedBatcher
    from repro_torch.serving import CodedServer, make_coded_forward
    out = {}
    for name in MODELS:
        cfg, code, b, params, batch = _model(name)
        comm = comm_for(code.n)
        for sched, pat, partial in SERVE_CASES:
            spec = coding.SchemeSpec(schedule=sched, partial=partial)
            srv = CodedServer(cfg, code, params, spec=spec,
                              batch_per_subset=b, seq_len=SEQ, device="cpu",
                              comm=comm)
            comm.reset_counts()
            res = srv.serve_batch(batch, stragglers=_pattern(name, pat))
            out[f"{name}-{sched}-{pat}"] = {
                "outputs": _bits(res.outputs),
                "err_bound": np.float64(res.err_bound).tobytes(),
                "within_slo": res.within_slo,
                "failed_rows": res.failed_rows,
                "stragglers": res.stragglers,
                "counts": dict(comm.counts), "bytes": dict(comm.bytes)}
        # the hedge through the forward itself: the straggler's payload
        # replaced by garbage decodes to the same bits
        one = MODELS[name][3]
        arts = make_coded_forward(cfg, code, batch_per_subset=b, seq_len=SEQ,
                                  device="cpu", comm=comm)
        placed = CodedBatcher(code).place(
            {k: torch.from_numpy(v) for k, v in batch.items()})
        junk = {k: v.clone() for k, v in placed.items()}
        for k, v in junk.items():
            v[one[0]] = (torch.randint_like(v[one[0]], 0, cfg.vocab)
                         if v.dtype == torch.int32 else -7.0 * v[one[0]])
        inp = arts.step_inputs(one)
        args = (inp["W"], inp["mask"], inp["rho"])
        comm.reset_counts()
        with torch.no_grad():
            clean = arts.step(params, placed, *args)
            dirty = arts.step(params, junk, *args)
        out[f"{name}-hedge"] = {"outputs": _bits(clean),
                                "junk_outputs": _bits(dirty),
                                "counts": dict(comm.counts),
                                "bytes": dict(comm.bytes)}
    return out


# ------------------------------------------------------------- the tuners
class _FixedClock:
    """``time`` for the trainer's and the server's modules: every
    ``perf_counter`` call moves 10 ms on, so every wall is 10 ms."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t

    @staticmethod
    def time():
        return time.time()


def _with_fixed_clock(fn):
    """Run ``fn()`` with the trainer's and server's clocks fixed."""
    from repro_torch.serving import engine
    from repro_torch.train import trainer
    saved = engine.time, trainer.time
    engine.time = trainer.time = _FixedClock()
    try:
        return fn()
    finally:
        engine.time, trainer.time = saved


def _tuned_server(comm, force_plan_at=None):
    """An autotuned linear server, TUNED_BATCHES batches: its scheme by
    batch, tuner events and outputs.  ``force_plan_at`` makes this process
    alone adopt another plan at that batch."""
    from repro_torch.core import make_code
    from repro_torch.core.runtime_model import RuntimeParams
    from repro_torch.serving import CodedServer
    from repro_torch.tune import (PoissonArrivals, ServingPolicy,
                                  ShiftedExpSampler)
    cfg, _, b, params, _ = _model("logistic")
    policy = ServingPolicy(arrivals=PoissonArrivals(rate_rps=0.05),
                           interval=3, min_samples=3, wait_draws=100,
                           n_requests=400)
    srv = CodedServer(cfg, make_code(4, 1, 0, 1), params, batch_per_subset=b,
                      straggler_source=ShiftedExpSampler(
                          RuntimeParams(**P_A), seed=0),
                      autotune=policy, device="cpu", comm=comm)
    x = np.random.default_rng(0).standard_normal(
        (srv.batch_requests, cfg.d_model)).astype(np.float32)
    schemes, outs = [], []
    for t in range(TUNED_BATCHES):
        if t == force_plan_at:
            srv._tuner.maybe_replan = lambda step: types.SimpleNamespace(
                d=3, s=2, m=1, schedule="a2a")
        outs.append(_bits(srv.serve_batch({"x": x}).outputs))
        schemes.append(srv._scheme_key())
    return {"schemes": schemes, "events": repr(srv._tuner.events),
            "outputs": outs}


def _tuned_trainer(comm, force_plan_at=None):
    """An autotuned synchronous trainer, TUNED_STEPS steps: its scheme by
    step, tuner events and state digest."""
    from repro_torch.core import make_code
    from repro_torch.core.runtime_model import RuntimeParams
    from repro_torch.data import make_synthetic_batch
    from repro_torch.launch.train import state_digest
    from repro_torch.optim import get_optimizer
    from repro_torch.train import Trainer
    from repro_torch.tune import AutotunePolicy, DriftingSampler
    drift = DriftingSampler([(0, RuntimeParams(**P_A)),
                             (6, RuntimeParams(**P_B))], seed=3)
    policy = AutotunePolicy(interval=3, window=6, min_samples=3,
                            schedules=("gather",), npts=4_000)
    tr = Trainer(LOGISTIC, make_code(4, 4, 2, 2),
                 get_optimizer("sgd", 1e-2), straggler_source=drift,
                 autotune=policy, device="cpu", comm=comm)
    rng = np.random.default_rng(0)
    schemes = []
    for t in range(TUNED_STEPS):
        if t == force_plan_at:
            tr._tuner.maybe_replan = lambda *a, **k: dataclasses.replace(
                tr._current_plan(), d=3, s=1, m=2, loads=(3,) * 4)
        tr.step(make_synthetic_batch(rng, LOGISTIC, 16, 0))
        schemes.append(repr(tr._scheme_sig))
    return {"schemes": schemes, "events": repr(tr.autotune_events),
            "digest": state_digest(tr.params, tr.opt_state)}


def _tuned_runs(comm_for):
    """Both tuned runs on the real clock and on the fixed one."""
    return {"server": _tuned_server(comm_for(4)),
            "trainer": _tuned_trainer(comm_for(4)),
            "server_fixed": _with_fixed_clock(
                lambda: _tuned_server(comm_for(4))),
            "trainer_fixed": _with_fixed_clock(
                lambda: _tuned_trainer(comm_for(4)))}


def _raised(fn):
    """(exception type, message) of ``fn()``, or (None, "")."""
    try:
        fn()
    except Exception as e:                   # noqa: BLE001 - reported
        return type(e).__name__, str(e)
    return None, ""


# ------------------------------------------------------------- checkpoints
def _ckpt_trainer(comm, directory=None, every=0):
    from repro_torch.core import make_code
    from repro_torch.optim import get_optimizer
    from repro_torch.train import Trainer
    from repro_torch.tune import FixedStragglers
    return Trainer(LOGISTIC, make_code(4, 3, 1, 2), get_optimizer("nag", 1e-2),
                   straggler_source=FixedStragglers((2,)),
                   checkpoint_dir=directory, checkpoint_every=every,
                   device="cpu", comm=comm)


def _ckpt_batches():
    from repro_torch.data import make_synthetic_batch
    rng = np.random.default_rng(5)
    return [make_synthetic_batch(rng, LOGISTIC, 16, 0)
            for _ in range(CKPT_STEPS)]


def _ckpt_run(comm, steps, directory=None, every=0, keep=None):
    """Run a (checkpointed) trainer from where its directory says for up
    to ``steps`` steps in all: its digest, the steps it restored and ran,
    and the snapshots this process saved."""
    from repro_torch.launch.train import state_digest
    tr = _ckpt_trainer(comm, directory, every)
    if keep is not None:
        tr._ckpt.keep = keep
    saved = []
    if tr._ckpt is not None:
        save = tr._ckpt.save
        tr._ckpt.save = lambda step, *a: saved.append(step) or save(step, *a)
    restored = tr._step_count
    stream = tr.skip_to_cursor(iter(_ckpt_batches()))
    for _ in range(steps - restored):
        tr.step(next(stream))
    return {"digest": state_digest(tr.params, tr.opt_state),
            "restored": restored, "steps": tr._step_count, "saved": saved}


def _ckpt_first(comm, dirs):
    """The first group's checkpoint runs: uninterrupted, cut at CKPT_CUT
    with a snapshot every CKPT_EVERY, and every step with keep 3."""
    return {"uninterrupted": _ckpt_run(comm, CKPT_STEPS),
            "cut": _ckpt_run(comm, CKPT_CUT, dirs["cut"], CKPT_EVERY),
            "keep": _ckpt_run(comm, 5, dirs["keep"], 1, keep=3)}


# ------------------------------------------------------------- the ranks
def _group_body(rank, nproc, device, dirs):
    """Everything one rank of a group runs (a case's failure is returned
    as its traceback, so the other cases still count)."""
    import traceback
    comms = {}

    def comm_for(n):
        if n not in comms:
            comms[n] = make_dist_comm(n, device=device)
        return comms[n]

    out = {}
    for key, fn in (("serve", lambda: _serve_cases(comm_for)),
                    ("tuned", lambda: _tuned_runs(comm_for)),
                    ("plan_mismatch", lambda: {
                        "trainer": _raised(lambda: _tuned_trainer(
                            comm_for(4), force_plan_at=7 if rank else None)),
                        "server": _raised(lambda: _tuned_server(
                            comm_for(4), force_plan_at=4 if rank else None))}),
                    ("ckpt", lambda: (_ckpt_first(comm_for(4), dirs)
                                      if dirs else None))):
        try:
            out[key] = fn()
        except Exception:                    # noqa: BLE001 - reported
            out[key] = traceback.format_exc()
    return out


def _resume_body(rank, nproc, device, dirs):
    """A fresh group: resume the cut run, then ranks whose directories
    hold different newest snapshots."""
    comm = make_dist_comm(4, device=device)
    resumed = _ckpt_run(comm, CKPT_STEPS, dirs["cut"], CKPT_EVERY)
    mismatch = _raised(lambda: _ckpt_trainer(
        comm, dirs["older"] if rank else dirs["cut"], CKPT_EVERY))
    return {"resumed": resumed, "mismatch": mismatch}


def _local_comm_for(n):
    return make_local_comm(n, "cpu")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_ckpt")
    return {k: str(root / k) for k in ("cut", "keep", "older")}


@pytest.fixture(scope="module")
def group2(dirs):
    return tranks.run_ranks(_group_body, 2, args=(dirs,), device="cpu",
                            backend="gloo", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def group4():
    return tranks.run_ranks(_group_body, 4, args=(None,), device="cpu",
                            backend="gloo", timeout=TIMEOUT)


@pytest.fixture
def group(request):
    return request.getfixturevalue(f"group{request.param}")


@pytest.fixture(scope="module")
def resumed(group2, dirs):
    """The fresh group, after the first has written its snapshots; the
    ``older`` directory holds the cut run's first snapshot alone."""
    older = pathlib.Path(dirs["older"])
    older.mkdir()
    first = sorted(pathlib.Path(dirs["cut"]).glob("ckpt_*.npz"))[0]
    shutil.copy(first, older / first.name)
    return tranks.run_ranks(_resume_body, 2, args=(dirs,), device="cpu",
                            backend="gloo", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def local_serve():
    return _serve_cases(_local_comm_for)


@pytest.fixture(scope="module")
def local_tuned():
    return _tuned_runs(_local_comm_for)


def _part(res, key):
    got = res[key]
    assert not isinstance(got, str), got     # else the rank's traceback
    return got


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("group", [2, 4], indirect=True)
def test_serve_is_bitwise_localcomm(group, local_serve, case):
    """Outputs, err_bound, failed rows and the collectives' counts and
    bytes of every rank are the single-process run's, bit for bit."""
    want = local_serve[case]
    for res in group:
        assert _part(res, "serve")[case] == want
    name, _, pat = case.split("-")
    if pat == "past_s":
        assert want["failed_rows"] and not np.frombuffer(
            want["err_bound"], np.float64)[0] < 0
    else:
        assert not want["failed_rows"]
    assert want["stragglers"] == _pattern(name, pat)
    assert sum(want["counts"].values()) >= 1


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("group", [2, 4], indirect=True)
def test_hedge_across_ranks_is_bitwise(group, local_serve, name):
    """A straggler's payload never reaches the output bits, on any rank,
    and every rank decodes the single-process bits."""
    want = local_serve[f"{name}-hedge"]
    assert want["junk_outputs"] == want["outputs"]
    for res in group:
        assert _part(res, "serve")[f"{name}-hedge"] == want


def test_past_s_certificate_is_nonzero_where_coded(local_serve):
    """Past s the coded schedules certify a positive bound and the psum
    baseline exactly zero (what the ranks are held to above)."""
    for name in MODELS:
        for sched in SCHEDULES:
            eb = np.frombuffer(local_serve[f"{name}-{sched}-past_s"]
                               ["err_bound"], np.float64)[0]
            assert (eb > 0) == (sched != "psum"), (name, sched, eb)


# ------------------------------------------------------------- the tuners
@pytest.mark.parametrize("run", ["server", "trainer"])
@pytest.mark.parametrize("group", [2, 4], indirect=True)
def test_tuned_ranks_adopt_the_same_plans(group, run):
    """On the real clock every rank adopts the same plans at the same
    batches or steps, logs the same events and ends alike; at least one
    switch happens."""
    runs = [_part(res, "tuned")[run] for res in group]
    assert all(r == runs[0] for r in runs[1:])
    assert len(set(runs[0]["schemes"])) >= 2, runs[0]["schemes"]


@pytest.mark.parametrize("run", ["server_fixed", "trainer_fixed"])
@pytest.mark.parametrize("group", [2, 4], indirect=True)
def test_tuned_ranks_on_a_fixed_clock_are_the_single_process(group,
                                                             local_tuned,
                                                             run):
    want = local_tuned[run]
    assert len(set(want["schemes"])) >= 2, want["schemes"]
    for res in group:
        assert _part(res, "tuned")[run] == want


@pytest.mark.parametrize("run", ["trainer", "server"])
def test_a_rank_with_another_plan_makes_every_rank_raise(group2, run):
    for res in group2:
        kind, msg = _part(res, "plan_mismatch")[run]
        assert kind == "RuntimeError", msg
        assert "the ranks disagree on the s" in msg
        assert "rank 0: " in msg and "rank 1: " in msg


# ------------------------------------------------------------- checkpoints
def test_only_the_root_saves_and_keep_holds(group2, dirs):
    """The root rank saved every snapshot, the other none; the directory
    holds exactly the ``keep`` newest of the every-step run and the cut
    run's two."""
    keep = [_part(res, "ckpt")["keep"] for res in group2]
    cut = [_part(res, "ckpt")["cut"] for res in group2]
    assert keep[0]["saved"] == [1, 2, 3, 4, 5] and keep[1]["saved"] == []
    assert cut[0]["saved"] == [2, 4] and cut[1]["saved"] == []
    assert sorted(p.name for p in pathlib.Path(dirs["keep"]).iterdir()) == [
        f"ckpt_{s:08d}.npz" for s in (3, 4, 5)]
    assert {f"ckpt_{s:08d}.npz" for s in (2, 4)} <= {
        p.name for p in pathlib.Path(dirs["cut"]).iterdir()}
    assert keep[0]["digest"] == keep[1]["digest"]


def test_a_fresh_group_resumes_bitwise(group2, resumed):
    """The fresh group restores step CKPT_CUT on both ranks and ends with
    the uninterrupted 2-rank run's state and the single-process run's."""
    single = _ckpt_run(make_local_comm(4, "cpu"), CKPT_STEPS)
    first = [_part(res, "ckpt")["uninterrupted"] for res in group2]
    for res in resumed:
        got = res["resumed"]
        assert got["restored"] == CKPT_CUT and got["steps"] == CKPT_STEPS
        assert got["digest"] == first[0]["digest"] == first[1]["digest"] \
            == single["digest"]
    assert resumed[0]["resumed"]["saved"] == [CKPT_STEPS]


def test_ranks_that_restore_different_steps_raise(resumed):
    for res in resumed:
        kind, msg = res["mismatch"]
        assert kind == "RuntimeError", msg
        assert "the restored checkpoint step" in msg
        assert f"rank 0: {CKPT_STEPS}" in msg and "rank 1: 2" in msg
