"""Serving-side planning: arrival processes, queue simulation, p99 ranking.

Training optimises the *mean* step time, so the PR 5 planner ranks plans by
``E[T_tot]``.  Serving carries a latency SLO: what matters is the tail of
the per-request sojourn time under a live arrival process, where a scheme
with a slightly worse mean but a lighter straggler tail can win p99
outright.  This module is the serving twin of ``repro.tune.planner``:

- :class:`PoissonArrivals` — the modeled millions-of-users request process
  (exponential interarrivals at ``rate_rps``);
- :func:`simulate_queue` — a deterministic batch-service queue simulation:
  requests arrive Poisson, the server takes up to ``batch_requests`` queued
  requests per coded forward, each batch's service time is one draw from
  the plan's service distribution; returns per-request sojourn percentiles
  and the offered utilization;
- :func:`rank_serving_plans` — scores every uniform ``(d, s, m)`` frontier
  triple x schedule under a fitted straggler model.  A plan's service
  distribution composes the modeled hedged wait (the ``(n-s)``-th order
  statistic of the Section-VI draws — the engine waits for the fastest
  ``n-s`` replicas only) with the measured step cost from the
  :class:`~repro.tune.planner.StepCostBook`.  Full replication is the
  frontier point ``(d, s, m) = (n, n-1, 1)`` (wait-for-fastest-1), so the
  coded-vs-replicated comparison happens *inside* one ranking; admission
  control marks plans whose utilization exceeds the policy bound;
- :class:`ServingPolicy` / :class:`ServingAutotuner` — the online re-plan
  loop the :class:`~repro.serving.CodedServer` drives, mirroring
  :class:`~repro.tune.policy.Autotuner` (fit -> cross-check -> rank ->
  hysteresis) but ranking by modeled p99 instead of ``E[T_tot]``.

The serving plan space stays in the uniform family (``k = n``): a re-plan
must not change the engine's global batch size ``k * b`` mid-flight.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..bench.straggler import draw_patterns

from .estimator import crosscheck_waits, fit_runtime_params
from .planner import StepCostBook, step_cost_book
from .telemetry import StepRecord, TelemetryLog


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Memoryless request arrivals at ``rate_rps`` requests/second."""

    rate_rps: float

    def __post_init__(self):
        """Reject non-positive rates (the queue sim would never terminate)."""
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")

    def arrival_times(self, rng: np.random.Generator,
                      size: int) -> np.ndarray:
        """(size,) cumulative arrival times of one sampled trace."""
        return np.cumsum(rng.exponential(1.0 / self.rate_rps, size))


def simulate_queue(service_s: Sequence[float], arrivals: PoissonArrivals, *,
                   batch_requests: int, n_requests: int = 3000,
                   seed: int = 0) -> dict[str, float]:
    """Batch-service queue: Poisson arrivals, up to B requests per forward.

    ``service_s`` is the plan's empirical service-time pool (modeled hedged
    wait + measured step cost, one entry per draw); each dispatched batch
    consumes one pool draw.  The server is work-conserving: when free it
    immediately takes ``min(queued, batch_requests)`` requests.  Returns
    per-request sojourn statistics (seconds) and the offered utilization
    ``rate * mean_service / batch_requests`` (>= 1 means the queue has no
    steady state and the measured tail is trace-length bound).
    """
    pool = np.asarray(service_s, dtype=np.float64)
    if pool.size == 0 or not np.isfinite(pool).all():
        raise ValueError("service_s must be a non-empty finite pool")
    B = int(batch_requests)
    if B < 1:
        raise ValueError(f"batch_requests must be >= 1, got {B}")
    rng = np.random.default_rng(seed)
    arr = arrivals.arrival_times(rng, int(n_requests))
    sojourn = np.empty_like(arr)
    t_free = 0.0
    i = 0
    while i < arr.size:
        start = max(arr[i], t_free)
        # every request already queued at dispatch joins, up to B
        j = i + int(np.searchsorted(arr[i:i + B], start, side="right"))
        j = max(j, i + 1)
        service = float(pool[rng.integers(pool.size)])
        done = start + service
        sojourn[i:j] = done - arr[i:j]
        t_free = done
        i = j
    util = arrivals.rate_rps * float(pool.mean()) / B
    return {
        "p50_s": float(np.percentile(sojourn, 50)),
        "p99_s": float(np.percentile(sojourn, 99)),
        "mean_s": float(sojourn.mean()),
        "utilization": float(util),
    }


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """One ranked serving operating point: scheme + modeled latency tail."""

    d: int                      # computation load per replica
    s: int                      # hedging budget: decode from fastest n-s
    m: int                      # communication reduction
    k: int                      # data subsets (= n: uniform family only)
    loads: tuple[int, ...]      # per-replica subset counts ((d,) * n)
    schedule: str               # gather | a2a
    predicted_service_s: float  # mean hedged wait + measured step cost
    p50_s: float                # modeled median request sojourn
    p99_s: float                # modeled p99 request sojourn (ranking key)
    utilization: float          # rate * E[service] / batch_requests
    admitted: bool              # utilization within the policy bound
    family: str = "uniform"

    @property
    def scheme_key(self) -> tuple:
        """Hashable identity of the codec this plan selects (sans costs)."""
        return (self.family, self.d, self.s, self.m, self.k, self.loads,
                self.schedule)

    def describe(self) -> str:
        """One-line human-readable summary."""
        return (f"serve-{self.family}(d={self.d},s={self.s},m={self.m}),"
                f"{self.schedule}: p99={self.p99_s:.3f}s "
                f"p50={self.p50_s:.3f}s util={self.utilization:.2f}"
                f"{'' if self.admitted else ' REJECTED'}")


def rank_serving_plans(fit, *, arrivals: PoissonArrivals,
                       batch_requests: int,
                       schedules: Sequence[str] = ("gather", "a2a"),
                       cost_book: StepCostBook | None = None,
                       min_s: int = 0,
                       wait_draws: int = 400,
                       n_requests: int = 3000,
                       max_utilization: float = 0.95,
                       seed: int = 0) -> list["ServePlan"]:
    """Rank every uniform frontier triple x schedule by modeled p99.

    ``fit`` is a :class:`~repro.tune.estimator.FitResult` (or anything with
    a ``params`` :class:`~repro.core.runtime_model.RuntimeParams`).  Each
    candidate's service pool is ``wait_draws`` hedged-wait samples (the
    ``(n-s)``-th order statistic under the fitted model — the serving
    engine's wait-for-fastest-``n-s`` hedge) shifted by the measured step
    cost; :func:`simulate_queue` turns the pool into sojourn percentiles
    under ``arrivals``.  Admitted plans (utilization <=
    ``max_utilization``) rank ahead of rejected ones; ties break toward
    the earlier schedule.  Full replication enters as ``(n, n-1, 1)``.
    """
    n = fit.params.n
    book = cost_book or StepCostBook()
    sched_rank = {sc: i for i, sc in enumerate(schedules)}
    out: list[tuple] = []
    for d in range(1, n + 1):
        for m in range(1, d + 1):
            s = d - m
            if s < min_s:
                continue
            pats = draw_patterns(fit.params, d, s, m, wait_draws,
                                 seed=seed + 7919 * d + 31 * m)
            waits = np.array([p.wait_s for p in pats])
            for schedule in schedules:
                step = book.cost(d, n, (d,) * n, schedule, True)
                pool = waits + step
                q = simulate_queue(pool, arrivals,
                                   batch_requests=batch_requests,
                                   n_requests=n_requests,
                                   seed=seed + 13 * d + m)
                admitted = q["utilization"] <= max_utilization
                plan = ServePlan(
                    d=d, s=s, m=m, k=n, loads=(d,) * n, schedule=schedule,
                    predicted_service_s=float(pool.mean()),
                    p50_s=q["p50_s"], p99_s=q["p99_s"],
                    utilization=q["utilization"], admitted=admitted)
                out.append(((0 if admitted else 1, q["p99_s"],
                             sched_rank[schedule]), plan))
    out.sort(key=lambda c: c[0])
    return [c[1] for c in out]


@dataclasses.dataclass(frozen=True)
class ServingPolicy:
    """Declarative configuration of the serving-side auto-planner."""

    arrivals: PoissonArrivals          # the modeled request process
    interval: int = 32                 # re-plan every N served batches
    window: int = 128                  # telemetry records per fit
    min_samples: int = 16              # records required before first fit
    schedules: tuple[str, ...] = ("gather", "a2a")
    min_s: int = 0                     # floor on the hedging budget
    switch_margin: float = 0.03        # min relative p99 gain to swap
    max_utilization: float = 0.95      # admission bound
    max_crosscheck_rel_err: float = 1.0  # reject fits worse than this
    wait_draws: int = 400              # service-pool samples per candidate
    n_requests: int = 3000             # simulated requests per candidate
    seed: int = 0


class ServingAutotuner:
    """Owns serving telemetry + fit state; decides codec switches by p99.

    The :class:`~repro.serving.CodedServer` appends one
    :class:`~repro.tune.telemetry.StepRecord` per served batch (per-replica
    timings from its straggler source, measured forward wall-clock) and
    calls :meth:`maybe_replan`; the loop mirrors
    :class:`~repro.tune.policy.Autotuner` — shifted-exp MLE on the window,
    cross-check rejection, ranked search, hysteresis — with
    :func:`rank_serving_plans` as the scorer.  Decisions append to
    ``events``.
    """

    def __init__(self, policy: ServingPolicy,
                 batch_requests: int, current: ServePlan | None = None):
        """``batch_requests``: the engine's global batch (k*b) in requests."""
        self.policy = policy
        self.batch_requests = int(batch_requests)
        self.telemetry = TelemetryLog(capacity=max(4 * policy.window, 256))
        self.current = current
        self.events: list[dict] = []
        self.last_fit = None
        self._since_plan = 0

    def record(self, rec: StepRecord) -> None:
        """Ingest one served batch's telemetry."""
        self.telemetry.append(rec)
        self._since_plan += 1

    def due(self) -> bool:
        """True when the next ``maybe_replan`` call will actually fit."""
        return (self._since_plan >= self.policy.interval
                and len(self.telemetry) >= self.policy.min_samples)

    def maybe_replan(self, step: int) -> ServePlan | None:
        """Fit + rank when due; return the new plan iff a switch is called."""
        p = self.policy
        if not self.due():
            return None
        self._since_plan = 0
        window = self.telemetry.window(p.window)
        fit = fit_runtime_params(window)
        self.last_fit = fit
        xcheck = crosscheck_waits(fit, window, npts=20_000)
        event = {"step": step, "crosscheck_rel_err": xcheck,
                 "fit": {"t1": fit.params.t1, "lambda1": fit.params.lambda1,
                         "t2": fit.params.t2, "lambda2": fit.params.lambda2}}
        if xcheck > p.max_crosscheck_rel_err:
            event.update(rejected_fit=True, switched=False, best=None)
            self.events.append(event)
            return None
        ranked = rank_serving_plans(
            fit, arrivals=p.arrivals, batch_requests=self.batch_requests,
            schedules=p.schedules, cost_book=step_cost_book(window),
            min_s=p.min_s, wait_draws=p.wait_draws,
            n_requests=p.n_requests, max_utilization=p.max_utilization,
            seed=p.seed + step)
        if not ranked:
            return None
        best = ranked[0]
        current_p99 = None
        if self.current is not None:
            for cand in ranked:
                if cand.scheme_key == self.current.scheme_key:
                    current_p99 = cand.p99_s
                    break
        switch = (self.current is None or current_p99 is None
                  or best.p99_s < current_p99 * (1.0 - p.switch_margin))
        event.update(best=best.describe(), current_p99_s=current_p99,
                     switched=bool(switch and (
                         self.current is None
                         or best.scheme_key != self.current.scheme_key)))
        if switch and (self.current is None
                       or best.scheme_key != self.current.scheme_key):
            event["from"] = (self.current.describe()
                             if self.current is not None else None)
            self.current = best
            self.events.append(event)
            return best
        self.events.append(event)
        return None
