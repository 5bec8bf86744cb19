"""The multi-process worker group (``repro_torch.comm.DistComm``) on the CPU
under ``gloo``: ranks started by the package's starter
(``repro_torch.launch.ranks.run_ranks``, a file rendezvous in a temporary
directory, a join timeout of at most 120 s; a rank's exception fails the
test), each computing only its own workers.

- Each collective, for 2 and 4 ranks, bitwise against ``LocalComm`` on the
  same inputs, with the same call and byte counts.
- The coded step on ``logistic-paper`` (d_model 64, code (8, 4, 2, 2)) and
  on reduced ``qwen3-1.7b`` (code (4, 3, 1, 2), S = 64): the synchronous
  step under ``gather``, ``a2a`` and ``psum`` and the pipelined fill +
  steady + drain, for 2 and 4 ranks (qwen3 under ``gather``: 3 steps on 2
  ranks, the first of them on 4).  Every rank's parameters, optimizer
  state (one digest of their bytes) and per-step metrics are bitwise those
  of the single-process run, and so are its collectives' counts and bytes.
- One step's bytes against the arithmetic of the step's ``PackPlan``.
- The 2-rank reduced-qwen3 3-step trajectory against the reference's
  ``Trainer`` on 8 forced host devices, from ``convert.py``'s parameters
  (``lm_train_cases.py``'s run and ``TRAJ_TOL``).
- What is refused: ``nccl`` with two ranks on one card, and a world size
  below 1; a rank that raises, dies or hangs ends its group with an error
  in time.  What once was refused and now constructs under a
  ``DistComm``: a world size that does not divide ``n`` (uneven blocks),
  ``autotune=``, ``checkpoint_dir=``, ``make_coded_forward``,
  ``CodedServer`` (``tests/test_torch_dist_serving.py`` runs them) and
  ``ElasticTrainer`` (``tests/test_torch_dist_elastic.py`` runs it, with
  every collective on uneven and empty blocks).
- ``python -m repro_torch.launch.train --device cpu --nproc 2
  --dist-backend gloo`` exits 0 with the final line of ``--nproc 1``, and
  so does ``--nproc 3`` on 4 workers (blocks of 1, 1 and 2).

Everything a rank runs is in this file or in the package, and this module
imports neither JAX nor the reference at its top, so that a rank imports
little.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import coding
from repro_torch.comm import DistComm, make_dist_comm, make_local_comm
from repro_torch.configs import get_config
from repro_torch.launch import ranks as tranks
from repro_torch.launch import train as tlaunch
from repro_torch.launch.train import TrainJob, job_rank, run_job
from repro_torch.tune import RandomStragglers

torch.set_num_threads(1)

SRC = pathlib.Path(repro_torch.__file__).resolve().parents[1]
TIMEOUT = 120.0
LOGISTIC = dataclasses.replace(get_config("logistic-paper"), d_model=64)
LOGISTIC_CODE = (8, 4, 2, 2)
LM = get_config("qwen3-1.7b").reduced()
LM_CODE = (4, 3, 1, 2)
SEQ = 64


def _lm_batches(steps):
    from repro_torch.data import make_synthetic_batch
    rng = np.random.default_rng(7)
    return tuple(make_synthetic_batch(rng, LM, 4, SEQ) for _ in range(steps))


def _jobs():
    """The step cases of a 2-rank group, by name."""
    sync = coding.SchemeSpec
    piped = dict(pipelined=True, fuse_apply=True)
    jobs = {}
    for sched in ("gather", "a2a", "psum"):
        jobs[f"logistic-{sched}"] = TrainJob(
            cfg=LOGISTIC, code=LOGISTIC_CODE, optimizer="nag", lr=1e-2,
            spec=sync(schedule=sched), stragglers=RandomStragglers(seed=1),
            steps=2, global_batch=32)
    for sched in ("gather", "a2a"):
        jobs[f"logistic-pipelined-{sched}"] = TrainJob(
            cfg=LOGISTIC, code=LOGISTIC_CODE, optimizer="sgd", lr=1e-2,
            spec=sync(schedule=sched, **piped),
            stragglers=RandomStragglers(seed=1), steps=3, global_batch=32)
    # the trajectory of lm_train_cases (its batches, stragglers and
    # optimizer; the parameters come from the reference's init)
    jobs["qwen3-gather"] = TrainJob(
        cfg=LM, code=LM_CODE, optimizer="nag", lr=1e-2,
        spec=sync(schedule="gather"), stragglers=RandomStragglers(seed=5),
        steps=3, batches=_lm_batches(3), keep_state=True)
    for sched in ("a2a", "psum"):
        jobs[f"qwen3-{sched}"] = TrainJob(
            cfg=LM, code=LM_CODE, optimizer="nag", lr=1e-2,
            spec=sync(schedule=sched), stragglers=RandomStragglers(seed=5),
            steps=1, batches=_lm_batches(1))
    jobs["qwen3-pipelined"] = TrainJob(
        cfg=LM, code=LM_CODE, optimizer="sgd", lr=1e-2,
        spec=sync(schedule="gather", **piped),
        stragglers=RandomStragglers(seed=5), steps=2,
        batches=_lm_batches(2))
    return jobs


def _first_step(job):
    """``job`` cut to its first step."""
    return dataclasses.replace(job, steps=1, batches=job.batches[:1],
                               keep_state=False)


JOBS = sorted(_jobs())
# (shape, dtype) of the collective cases; the leading axis is n
COLLECTIVE_INPUTS = [((8, 24), "float32"), ((8, 16, 3), "float32"),
                     ((8, 40), "float64"), ((4, 8, 2), "float32")]


def _inputs():
    rng = np.random.default_rng(11)
    return [torch.from_numpy(rng.standard_normal(shape).astype(dtype))
            for shape, dtype in COLLECTIVE_INPUTS]


def _bits(t):
    """A tensor as (dtype, shape, bytes): equal exactly when bitwise equal."""
    t = t.detach().contiguous()
    return str(t.dtype), tuple(t.shape), t.reshape(-1).view(torch.uint8) \
        .numpy().tobytes()


def _collectives(comm, x):
    """One call of each collective on this process's rows of ``x``."""
    comm.reset_counts()
    out = {k: _bits(getattr(comm, k)(comm.rows(x)))
           for k in ("all_gather", "all_to_all", "psum")}
    return out, dict(comm.counts), dict(comm.bytes)


def _refusals(device, ckpt_dir):
    """What a rank refuses, or builds, under a DistComm: {case: (type,
    message)}, ``(None, "")`` for a call that raised nothing."""
    from repro_torch.core import make_code
    from repro_torch.core.runtime_model import RuntimeParams
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.optim import nag
    from repro_torch.serving import CodedServer, make_coded_forward
    from repro_torch.train import Trainer
    from repro_torch.tune import AutotunePolicy, ShiftedExpSampler
    comm = make_dist_comm(4, device=device)
    code = make_code(4, 3, 1, 2)
    cfg = dataclasses.replace(LOGISTIC, d_model=8)
    timed = ShiftedExpSampler(RuntimeParams(n=4, lambda1=1.0, lambda2=1.0,
                                            t1=1.0, t2=1.0))
    cases = {
        "world size does not divide n":
            lambda: make_dist_comm(3, device=device).workers,
        "autotune": lambda: Trainer(cfg, code, nag(1e-3), device=device,
                                    comm=comm, autotune=AutotunePolicy(),
                                    straggler_source=timed),
        "checkpoint_dir": lambda: Trainer(cfg, code, nag(1e-3), device=device,
                                          comm=comm,
                                          checkpoint_dir=ckpt_dir),
        "ElasticTrainer": lambda: ElasticTrainer(cfg, code, nag(1e-3),
                                                 device=device, comm=comm),
        "make_coded_forward": lambda: make_coded_forward(
            LM, code, device=device, comm=comm),
        "CodedServer": lambda: CodedServer(LM, code, {}, device=device,
                                           comm=comm),
    }
    out = {}
    for name, fn in cases.items():
        try:
            got = fn()
            out[name] = (None, repr(got) if isinstance(got, range) else "")
        except Exception as e:               # noqa: BLE001 - reported
            out[name] = (type(e).__name__, str(e))
    return out


def _group_body(rank, nproc, device, jobs, ckpt_dir):
    """Everything one rank of a group runs: the collectives, the refusals
    and every step case (a case's failure is reported, not raised, so the
    other cases still count)."""
    import traceback
    comm = make_dist_comm(8, device=device)
    out = {"workers": (comm.workers.start, comm.workers.stop),
           "collectives": [], "jobs": {}}
    for x in _inputs():
        n = x.shape[0]
        c = comm if n == 8 else make_dist_comm(n, device=device)
        out["collectives"].append(_collectives(c, x))
    out["refusals"] = _refusals(device, ckpt_dir)
    for name, job in jobs.items():
        try:
            out["jobs"][name] = job_rank(rank, nproc, device, job)
        except Exception:                    # noqa: BLE001 - reported
            out["jobs"][name] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def lm_start():
    """The reference's seed-3 initial parameters of reduced qwen3-1.7b
    (``lm_train_cases.init_params``), as numpy."""
    import lm_train_cases as cases
    return cases.init_params()


@pytest.fixture(scope="module")
def jobs(lm_start):
    """The step cases by group size: 2 ranks run qwen3's 3-step trajectory
    (also held against the reference), 4 ranks its first step; every other
    case is the same job on both."""
    two = _jobs()
    two["qwen3-gather"] = dataclasses.replace(two["qwen3-gather"],
                                              params=lm_start)
    return {2: two, 4: {**two, "qwen3-gather": _first_step(
        two["qwen3-gather"])}}


@pytest.fixture(scope="module")
def local(jobs):
    """Each case's single-process run (``LocalComm``) by group size; a job
    both groups share runs once."""
    two = {name: run_job(job, "cpu") for name, job in jobs[2].items()}
    return {2: two, 4: {name: two[name] if job is jobs[2][name]
                        else run_job(job, "cpu")
                        for name, job in jobs[4].items()}}


def _group(nproc, jobs, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp(f"ckpt{nproc}"))
    return tranks.run_ranks(_group_body, nproc, args=(jobs[nproc], ckpt),
                            device="cpu", backend="gloo", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def group2(jobs, tmp_path_factory):
    return _group(2, jobs, tmp_path_factory)


@pytest.fixture(scope="module")
def group4(jobs, tmp_path_factory):
    return _group(4, jobs, tmp_path_factory)


@pytest.fixture
def group(request):
    return request.getfixturevalue(f"group{request.param}")


# ------------------------------------------------------------- collectives
@pytest.mark.parametrize("group", [2, 4], indirect=True)
def test_each_collective_is_bitwise_localcomm(group):
    nproc = len(group)
    for rank, res in enumerate(group):
        assert res["workers"] == (rank * 8 // nproc, (rank + 1) * 8 // nproc)
        for x, (got, counts, nbytes) in zip(_inputs(), res["collectives"],
                                            strict=True):
            n = x.shape[0]
            local = make_local_comm(n, "cpu")
            want_a2a = local.all_to_all(x)
            w = n // nproc
            assert got["all_gather"] == _bits(local.all_gather(x))
            assert got["all_to_all"] == _bits(
                want_a2a[rank * w:(rank + 1) * w])
            assert got["psum"] == _bits(local.psum(x))
            assert counts == local.counts == {"all_gather": 1,
                                              "all_to_all": 1, "psum": 1}
            assert nbytes == local.bytes


def test_dist_comm_rows_and_transport(group2):
    """Rank r's rows of a per-worker tensor are its block of workers."""
    comm = make_local_comm(8, "cpu")
    x = torch.arange(8.0)
    assert torch.equal(comm.rows(x), x) and comm.workers == range(8)
    assert [tuple(r["workers"]) for r in group2] == [(0, 4), (4, 8)]
    for r in group2:
        job = r["jobs"]["logistic-gather"]
        assert job["transport"] == "gloo, cpu tensors handed over as is"
        assert job["device"] == "cpu"


# ------------------------------------------------------------- the step
def _rank_report(res, name):
    got = res["jobs"][name]
    assert isinstance(got, dict), got        # else the rank's traceback
    return got


def _metric_bits(logs):
    return [tuple(np.float64(m[k]).tobytes() for k in ("loss", "grad_norm"))
            for m in logs]


@pytest.mark.parametrize("name", JOBS)
@pytest.mark.parametrize("group", [2, 4], indirect=True)
def test_step_is_bitwise_localcomm(group, local, name):
    """Parameters, optimizer state, metrics and collectives of every rank
    are the single-process run's, bit for bit."""
    want = local[len(group)][name]
    assert want["workers"] == [0, want_n(name)]
    for rank, res in enumerate(group):
        got = _rank_report(res, name)
        assert got["rank"] == rank
        assert got["digest"] == want["digest"]
        assert _metric_bits(got["logs"]) == _metric_bits(want["logs"])
        assert [{k: c[k] for k in ("counts", "bytes")}
                for c in got["collectives"]] == want["collectives"]
        w = want_n(name) // len(group)
        assert got["workers"] == [rank * w, (rank + 1) * w]
    if "pipelined" in name:                  # a fill, steady steps, a drain
        assert np.isnan(want["logs"][0]["loss"])
        assert len(want["logs"]) == (4 if name.startswith("logistic") else 3)
        assert np.isfinite([m["loss"] for m in want["logs"][1:]]).all()


def want_n(name):
    return (LOGISTIC_CODE if name.startswith("logistic") else LM_CODE)[0]


@pytest.mark.parametrize("schedule", ["gather", "a2a", "psum"])
def test_step_bytes_follow_the_pack_plan(local, jobs, schedule):
    """One synchronous logistic-paper step's collectives, counted by the
    bytes one worker receives: per bucket ``n * L_b * 4`` gathered
    (``gather``); ``L_b * 4`` exchanged and ``L_b * m * 4`` of decoded
    slices gathered (``a2a``); the ``d_model``-element gradient summed
    (``psum``); and the 4-byte loss summed."""
    from repro_torch.core import make_code
    from repro_torch.train import make_coded_train_step
    from repro_torch.optim import nag
    n, _, _, m = LOGISTIC_CODE
    arts = make_coded_train_step(LOGISTIC, make_code(*LOGISTIC_CODE),
                                 nag(1e-2), spec=coding.SchemeSpec(
                                     schedule=schedule), device="cpu")
    sizes = ([b.size for b in arts.pack_plan.buckets]
             if arts.pack_plan is not None else [])
    want = {"gather": {"all_gather": sum(n * L * 4 for L in sizes),
                       "all_to_all": 0, "psum": 4},
            "a2a": {"all_gather": sum(L * m * 4 for L in sizes),
                    "all_to_all": sum(L * 4 for L in sizes), "psum": 4},
            "psum": {"all_gather": 0, "all_to_all": 0,
                     "psum": LOGISTIC.d_model * 4 + 4}}[schedule]
    assert sizes or schedule == "psum"
    for step in local[2][f"logistic-{schedule}"]["collectives"]:
        assert step["bytes"] == want


def test_replicas_and_trajectory_match_the_reference(group2, lm_start):
    """The 2-rank reduced-qwen3 trajectory (3 steps, gather, NAG, random
    stragglers) against the reference's ``Trainer`` on the same batches
    and parameters, at ``TRAJ_TOL``; both ranks hold the same state."""
    import jax
    import lm_train_cases as cases
    if len(jax.devices()) < cases.CODE[0]:
        pytest.skip(f"needs {cases.CODE[0]} devices")
    assert cases.CODE == LM_CODE and cases.SEQ == SEQ and cases.STEPS == 3
    for want, got in zip(cases.batches(), _lm_batches(3), strict=True):
        assert all(np.array_equal(want[k], got[k]) for k in want)
    jm, jp, js = cases.reference_run("gather", "nag", False)
    reps = [_rank_report(r, "qwen3-gather") for r in group2]
    assert reps[0]["digest"] == reps[1]["digest"]
    got = reps[0]
    assert len(got["logs"]) == len(jm) == 3
    for a, b in zip(jm, got["logs"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(b[k], a[k], err_msg=k,
                                       **cases.TRAJ_TOL)
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        leaf = got["state"]["params"]
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, want, err_msg=str(path),
                                   **cases.TRAJ_TOL)
    st = got["state"]["opt_state"]
    assert set(st) == set(js)
    for k in js:
        for a, b in zip(jax.tree.leaves(js[k]), jax.tree.leaves(st[k])):
            np.testing.assert_allclose(b, a, err_msg=k, **cases.TRAJ_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_state_digest_sees_a_one_ulp_change(dtype):
    """The replicas' digest: equal for equal bits, different after a one-ulp
    change of any one element (first, inside a later checksum chunk,
    last) of a parameter or of the optimizer state."""
    from repro_torch.launch.train import state_digest
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, 5, generator=g).to(dtype),
              "b": torch.randn((1 << 22) + 7, generator=g).to(dtype)}
    state = {"x_prev": {k: v.clone() for k, v in params.items()},
             "lam": torch.tensor(1.5)}
    want = state_digest(params, state)
    assert state_digest({k: v.clone() for k, v in params.items()},
                        state) == want
    for where in (("params", "a", 0), ("params", "b", (1 << 22) + 1),
                  ("params", "b", -1), ("x_prev", "b", 5)):
        p2 = {k: v.clone() for k, v in params.items()}
        s2 = {"x_prev": {k: v.clone() for k, v in params.items()},
              "lam": state["lam"]}
        tree, key, i = where
        t = (p2 if tree == "params" else s2["x_prev"])[key].view(-1)
        words = t.view({2: torch.int16, 4: torch.int32,
                        8: torch.int64}[t.element_size()])
        words[i] += 1                        # the last bit: one ulp
        assert state_digest(p2, s2) != want, where


# ------------------------------------------------------------- refusals
# the tuners, checkpoints, coded serving, uneven blocks and the elastic
# trainer were refused until they ran across ranks: their cases now assert
# that the same calls raise nothing (the 3 workers of the uneven case split
# 1 and 2 over the 2 ranks)
@pytest.mark.parametrize("case,kind,words", [
    ("world size does not divide n", None, "range("),
    ("autotune", None, ""),
    ("checkpoint_dir", None, ""),
    ("ElasticTrainer", None, ""),
    ("make_coded_forward", None, ""),
    ("CodedServer", None, "")])
def test_refused_under_a_dist_comm(group2, case, kind, words):
    for rank, res in enumerate(group2):
        got_kind, msg = res["refusals"][case]
        assert got_kind == kind and words in msg, (got_kind, msg)
        if case == "world size does not divide n":
            assert msg == repr(range(rank * 3 // 2, (rank + 1) * 3 // 2))


def test_world_size_that_does_not_divide_n_is_refused_before_a_group():
    """No world size of at least one rank is refused for its split any
    more (uneven blocks); what is refused before a group is made is a world
    size below one."""
    import torch.distributed as dist
    from repro_torch.comm import check_group
    for ws in (1, 2, 3, 5):
        check_group(ws, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="at least one rank, not 0"):
        make_dist_comm(4, device="cpu", world_size=0, rank=0,
                       init_method="file:///nonexistent/rendezvous")
    assert not dist.is_initialized()


def test_nccl_with_two_ranks_on_one_card_is_refused(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="gloo"):
        make_dist_comm(4, device="cuda", backend="nccl", world_size=2,
                       rank=0, init_method="file:///nonexistent/rendezvous")
    with pytest.raises(ValueError, match="gloo"):
        tranks.run_ranks(_collectives, 2, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        make_dist_comm(4, device="cpu", backend="nccl", world_size=1, rank=0)
    assert not dist.is_initialized()


def test_make_dist_comm_needs_the_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dist_comm(4)
    assert issubclass(DistComm, repro_torch.comm.Comm)


# ------------------------------------------------------------- the starter
def _fails(rank, nproc, device, how):
    import torch.distributed as dist
    dist.barrier()                           # both ranks are in the group
    if rank == 1:
        if how == "raises":
            raise ArithmeticError("rank one gives up")
        if how == "dies":
            time.sleep(2)                    # rank 0 is out of the barrier
            os._exit(3)
        time.sleep(3600)                     # hangs
    return rank


@pytest.mark.parametrize("how,error,words,timeout", [
    ("raises", RuntimeError, "ArithmeticError: rank one gives up", TIMEOUT),
    ("dies", RuntimeError, "rank 1 of 2 exited with code 3", TIMEOUT),
    ("hangs", TimeoutError, "1] of 2 gave no result within 5.0 s", 5.0)])
def test_a_failed_or_hung_rank_ends_its_group_in_time(how, error, words,
                                                      timeout):
    t0 = time.monotonic()
    with pytest.raises(error) as e:
        tranks.run_ranks(_fails, 2, args=(how,), device="cpu",
                         timeout=timeout)
    assert words in str(e.value)
    assert time.monotonic() - t0 < 40


# ------------------------------------------------------------- the launcher
# reduced logistic-paper (d_model 256), code (4, 3, 1, 2)
LAUNCH = ["--arch", "logistic-paper", "--steps", "2", "--optimizer", "nag",
          "--lr", "1e-2", "--device", "cpu"]


def test_launcher_on_two_ranks_prints_the_single_process_line(capsys):
    logs = tlaunch.main(LAUNCH)
    want = capsys.readouterr().out.splitlines()
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
         "--nproc", "2", "--dist-backend", "gloo"], capture_output=True,
        text=True, env=env,
        timeout=TIMEOUT + 30)
    assert res.returncode == 0, res.stderr[-3000:]
    got = res.stdout.splitlines()
    assert got[0] == ("ranks 2 (gloo): rank 0 on cpu workers 0-1, rank 1 on "
                      "cpu workers 2-3")
    assert got[-1] == want[-1] and got[-1].startswith("final loss ")
    assert len(got) == len(want) + 1 and len(logs) == 2


def test_launcher_refuses_a_split_it_cannot_make(capsys):
    """The split it once refused, 4 workers over 3 ranks, now runs in
    blocks of 1, 1 and 2 and prints the single-process final line."""
    logs = tlaunch.main(LAUNCH)
    want = capsys.readouterr().out.splitlines()
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
         "--nproc", "3", "--dist-backend", "gloo"], capture_output=True,
        text=True, env=env, timeout=TIMEOUT + 30)
    assert res.returncode == 0, res.stderr[-3000:]
    got = res.stdout.splitlines()
    assert got[0] == ("ranks 3 (gloo): rank 0 on cpu workers 0, rank 1 on "
                      "cpu workers 1, rank 2 on cpu workers 2-3")
    assert got[-1] == want[-1] and got[-1].startswith("final loss ")
    assert len(got) == len(want) + 1 and len(logs) == 2
