"""Per-step timing telemetry: what the auto-tuner measures.

The tuner's measure->fit->re-plan loop starts here.  Every training step
produces one :class:`StepRecord` carrying

- the **scheme signature** the step ran under (``d, s, m, k``, per-worker
  ``loads``, schedule, packed flag) — the estimator needs it to normalise
  timings into per-subset / per-encoding samples, and the planner needs it
  to calibrate predicted step costs per configuration;
- the per-worker **compute** and **communication** durations (seconds) —
  separately, because the Section-VI model is a sum of two independent
  shifted exponentials and the MLE fits each from its own samples;
- the induced **straggler set** and the master's modeled **wait** (the
  ``(n - n_drop)``-th order statistic of the per-worker totals);
- the measured **wall-clock** of the jitted step itself.

Records accumulate in a bounded :class:`TelemetryLog`; the estimator fits on
``log.window(policy.window)``.

On a real cluster the per-worker durations come from worker heartbeats; on
the single-host meshes this repo runs on they come from an *injector* — a
callable ``(step, code) -> WorkerTimes`` drawing from the same
shifted-exponential process the benchmarks use.  :class:`ShiftedExpSampler`
is the stationary injector; :class:`DriftingSampler` switches the underlying
:class:`~repro.core.runtime_model.RuntimeParams` (and optionally the
per-worker speed vector) at configured step boundaries, which is the drift
scenario ``benchmarks/bench_autotune.py`` gates.

>>> from repro.core.runtime_model import RuntimeParams
>>> samp = ShiftedExpSampler(RuntimeParams(n=4, lambda1=1, lambda2=1,
...                                        t1=1.0, t2=2.0), seed=0)
>>> wt = samp.draw(loads=(3,) * 4, k=4, m=2)
>>> wt.compute_s.shape, wt.comm_s.shape
((4,), (4,))
>>> bool((wt.compute_s >= 3 * 1.0).all())   # d*t1 shift is a hard floor
True
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.runtime_model import RuntimeParams


@dataclasses.dataclass(frozen=True)
class WorkerTimes:
    """One step's per-worker durations (seconds), compute and comm apart."""

    compute_s: np.ndarray  # (n,) time to finish the worker's assigned subsets
    comm_s: np.ndarray     # (n,) time to transmit the worker's l/m encoding

    @property
    def total_s(self) -> np.ndarray:
        """(n,) per-worker finish times: compute + communication."""
        return self.compute_s + self.comm_s

    def order_stat(self, n_drop: int) -> tuple[tuple[int, ...], float]:
        """Drop the ``n_drop`` slowest workers; return (stragglers, wait).

        The wait is the ``(n - n_drop)``-th order statistic of the totals —
        the same bookkeeping as
        :func:`repro.bench.straggler.draw_patterns`.  Missing per-worker
        times (NaN — a worker whose heartbeat never arrived, e.g. one that
        departed mid-step) are treated as ``+inf``: the worker is always
        among the dropped and the wait stays finite as long as the drop
        budget covers the missing workers.
        """
        t = np.where(np.isnan(self.total_s), np.inf, self.total_s)
        n = t.shape[0]
        order = np.argsort(t)
        slow = tuple(int(i) for i in order[n - n_drop:]) if n_drop else ()
        return slow, float(t[order[n - n_drop - 1]])


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """One training step's telemetry: scheme signature + timings."""

    step: int
    d: int                      # max per-worker load (batch-slot count)
    s: int                      # design straggler budget
    m: int                      # communication reduction factor
    k: int                      # number of data subsets (n for uniform codes)
    loads: tuple[int, ...]      # per-worker subset counts
    schedule: str               # gather | a2a | psum
    packed: bool                # bucketed flat wire vs per-leaf collectives
    compute_s: np.ndarray       # (n,) per-worker compute durations
    comm_s: np.ndarray          # (n,) per-worker communication durations
    stragglers: tuple[int, ...] = ()
    wait_s: float = 0.0         # modeled master wait (order statistic)
    measured_step_s: float = 0.0  # wall-clock of the jitted step
    pipelined: bool = False     # async double-buffered wire (stale-1)
    compile_s: float = 0.0      # one-time trace+compile wall of fresh steps

    @property
    def n(self) -> int:
        """Number of workers."""
        return len(self.loads)


def scheme_loads(code) -> tuple[int, ...]:
    """Per-worker subset loads of any ``GradCode``-duck scheme object
    (uniform fallback ``(d,) * n`` for minimal ducks without ``loads``)."""
    return tuple(getattr(code, "loads", (code.d,) * code.n))


def scheme_k(code) -> int:
    """Subset count ``k`` of any ``GradCode``-duck scheme object (``n``
    for ducks without ``num_subsets`` — the uniform family's value)."""
    return int(getattr(code, "num_subsets", code.n))


def record_from_times(step: int, code, schedule: str, packed: bool,
                      times: WorkerTimes, n_drop: int | None = None,
                      measured_step_s: float = 0.0,
                      pipelined: bool = False,
                      compile_s: float = 0.0) -> StepRecord:
    """Build a :class:`StepRecord` from a code object and a timing draw.

    ``code`` is any scheme with the ``GradCode`` duck surface (``d``, ``s``,
    ``m``, ``num_subsets``, ``loads``); ``n_drop`` defaults to the design
    ``s`` (the master drops the slowest ``s`` workers).  ``compile_s``
    carries the one-time trace+compile wall of a fresh executable's first
    call — the planner's :class:`~repro.tune.planner.StepCostBook` pools it
    into the recompile-amortization charge for membership-aware
    (stay-degraded vs resize) candidates.
    """
    slow, wait = times.order_stat(code.s if n_drop is None else n_drop)
    return StepRecord(
        step=step, d=code.d, s=code.s, m=code.m,
        k=scheme_k(code), loads=scheme_loads(code),
        schedule=schedule, packed=packed,
        compute_s=times.compute_s, comm_s=times.comm_s,
        stragglers=slow, wait_s=wait, measured_step_s=measured_step_s,
        pipelined=pipelined, compile_s=compile_s)


class TelemetryLog:
    """Bounded append-only buffer of :class:`StepRecord`."""

    def __init__(self, capacity: int = 4096):
        """``capacity`` bounds memory: the oldest records are discarded."""
        self.capacity = int(capacity)
        self._records: list[StepRecord] = []

    def append(self, record: StepRecord) -> None:
        """Append one step's record, evicting the oldest past capacity."""
        self._records.append(record)
        if len(self._records) > self.capacity:
            del self._records[: len(self._records) - self.capacity]

    def window(self, size: int) -> list[StepRecord]:
        """The most recent ``size`` records (fewer if the log is shorter)."""
        return self._records[-size:] if size else []

    @property
    def records(self) -> list[StepRecord]:
        """Every retained record, oldest first."""
        return list(self._records)

    def __len__(self) -> int:
        """Number of retained records."""
        return len(self._records)


class ShiftedExpSampler:
    """Stationary shifted-exponential injector (the Section-VI process).

    Worker ``i`` holding ``loads[i]`` of ``k`` equal subsets at relative
    speed ``speeds[i]`` draws

        compute_i = (loads[i] * n / k) * (t1 + Exp(lambda1)) / speeds[i]
        comm_i    = (t2 + Exp(lambda2)) / m

    — exactly the per-worker decomposition behind
    :func:`repro.bench.straggler.draw_patterns_hetero`, but with the two
    terms kept apart so the estimator can fit each shifted exponential from
    its own samples.  Instances are callables with the Trainer's injector
    signature ``(step, code) -> WorkerTimes``.
    """

    def __init__(self, params: RuntimeParams,
                 speeds: Sequence[float] | None = None, seed: int = 0):
        """``params`` is the ground-truth model; ``speeds`` (default all 1)
        scales each worker's compute rate."""
        self.params = params
        self.speeds = (np.ones(params.n) if speeds is None
                       else np.asarray(speeds, dtype=np.float64))
        self._rng = np.random.default_rng(seed)

    def draw(self, loads: Sequence[int], k: int, m: int) -> WorkerTimes:
        """One step's per-worker compute/comm durations for a scheme."""
        p = self.params
        n = p.n
        loads_arr = np.asarray(loads, dtype=np.float64)
        scale = loads_arr * n / (k * self.speeds)
        comp = scale * (p.t1 + self._rng.exponential(1.0 / p.lambda1, n))
        comm = (p.t2 + self._rng.exponential(1.0 / p.lambda2, n)) / m
        return WorkerTimes(compute_s=comp, comm_s=comm)

    def __call__(self, step: int, code) -> WorkerTimes:
        """Trainer injector hook: draw for the trainer's active code."""
        return self.draw(scheme_loads(code), scheme_k(code), code.m)


class DriftingSampler:
    """Injector whose ground-truth model drifts at step boundaries.

    ``phases`` is a sequence of ``(start_step, RuntimeParams)`` (or
    ``(start_step, RuntimeParams, speeds)``) entries sorted by start step;
    the draw at step ``t`` uses the last phase with ``start_step <= t``.
    This is the cluster-drift scenario the `autotune` bench gates: a static
    plan chosen for phase 0 goes stale the moment the distribution moves.
    """

    def __init__(self, phases: Sequence[tuple], seed: int = 0):
        """``phases``: [(start_step, params[, speeds]), ...] ascending."""
        if not phases:
            raise ValueError("need at least one phase")
        norm = []
        for ph in phases:
            start, params = ph[0], ph[1]
            speeds = ph[2] if len(ph) > 2 else None
            norm.append((int(start), params, speeds))
        if [p[0] for p in norm] != sorted(p[0] for p in norm):
            raise ValueError("phase start steps must be ascending")
        self.phases = norm
        self._seed = seed
        self._samplers = [ShiftedExpSampler(p, sp, seed=seed + 17 * i)
                          for i, (_, p, sp) in enumerate(norm)]

    def phase_at(self, step: int) -> int:
        """Index of the phase active at ``step``."""
        idx = 0
        for i, (start, _, _) in enumerate(self.phases):
            if step >= start:
                idx = i
        return idx

    def params_at(self, step: int) -> RuntimeParams:
        """The ground-truth :class:`RuntimeParams` active at ``step``."""
        return self.phases[self.phase_at(step)][1]

    def __call__(self, step: int, code) -> WorkerTimes:
        """Trainer injector hook: draw from the phase active at ``step``."""
        return self._samplers[self.phase_at(step)](step, code)
