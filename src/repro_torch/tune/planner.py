"""Plan search: rank the reachable operating points under a fitted model.

Given a :class:`~repro.tune.estimator.FitResult` the planner scores every
reachable configuration

    (d, s, m) on the optimal frontier  x  schedule  x  packed  x  family

and returns a ranked list of :class:`Plan`.  Each plan's predicted cost is

    predicted_total_s = predicted_wait_s + predicted_step_s

where ``predicted_wait_s`` is the cluster wait under the fitted straggler
model — the analytic ``E[T_tot]`` order-statistic integral
(:func:`~repro.core.runtime_model.expected_total_runtime`) for uniform
triples, a Monte-Carlo mean (:func:`~repro.bench.straggler.
draw_patterns_hetero`, which reduces to the same model) for
heterogeneous-load plans — and ``predicted_step_s`` calibrates in the
*measured* wall-clock of the jitted step from telemetry: the mean observed
step time per ``(schedule, packed)`` configuration
(:func:`step_cost_book`), falling back to the cheapest observed
configuration for ones not yet tried.  Modeled wait and measured step cost
live on the same axis (seconds), so the calibration is a straight sum.

Heterogeneous plans enter the ranking only when the fitted speed spread
clears the policy threshold (on a homogeneous cluster they cannot beat the
uniform scheme and only add Monte-Carlo noise) or when explicitly forced.

The deterministic anchor: fed the paper's n=8 Section VI-A constants, the
top uniform plan is the paper's optimum ``(d, s, m) = (4, 1, 3)``
(``tests/test_tune.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..bench.straggler import draw_patterns_hetero, mean_wait_s
from ..core.approx import APPROX_FAMILIES, approx_candidates
from ..core.hetero import plan_hetero
from ..core.runtime_model import (expected_order_stat,
                                      expected_total_runtime,
                                      expected_total_runtime_overlapped)
from ..core.stable import (STABLE_FAMILIES, classic_certified_cond,
                               stable_candidates)

from .estimator import FitResult
from .telemetry import StepRecord

# Per-step pipeline overhead charged to overlapped candidates (seconds):
# the double-buffer bookkeeping is nearly free, but a strictly-zero epsilon
# would let a pipelined plan tie its synchronous twin even when compute or
# comm fully hides the other phase, and ties must break toward the simpler
# scheme.
PIPELINE_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class Plan:
    """One ranked operating point: scheme + schedule + wire format + cost."""

    family: str    # uniform | hetero | frc | expander | chebyshev | rotation | block
    d: int                      # computation load (max per-worker for hetero)
    s: int                      # straggler budget (drop budget for approx)
    m: int                      # communication reduction
    k: int                      # data subsets (n for uniform)
    loads: tuple[int, ...]      # per-worker subset counts
    schedule: str               # gather | a2a
    packed: bool                # bucketed wire vs per-leaf collectives
    predicted_wait_s: float     # modeled cluster wait under the fit
    predicted_step_s: float     # calibrated measured step cost
    predicted_total_s: float    # wait + step: the ranking key
    pipelined: bool = False     # async double-buffered wire (stale-1)
    resize_to: int | None = None  # elastic: rebuild the cluster at this n
    #: approx families: worst-case decode-error certificate at the plan's
    #: drop budget ``s`` (``worst_err_bound(s)``); 0.0 for exact families
    err_bound: float = 0.0
    #: certified worst-|F| ``cond(V_F V_F^T)`` of the plan's construction —
    #: the quantity the ``max_cond`` admission gate checked; 0.0 when the
    #: gate was off (no certificate computed)
    cond_bound: float = 0.0
    #: block composite family: tile size of the 2D composition (the plan's
    #: construction is rebuilt from ``(family, d, s, m, n0)``)
    n0: int | None = None

    @property
    def scheme_key(self) -> tuple:
        """Hashable identity of the codec this plan selects (sans costs)."""
        return (self.family, self.d, self.s, self.m, self.k, self.loads,
                self.schedule, self.packed, self.pipelined, self.resize_to,
                self.n0)

    def describe(self) -> str:
        """One-line human-readable summary."""
        extra = f",loads={list(self.loads)},k={self.k}" \
            if self.family == "hetero" else ""
        if self.family == "block":
            extra += f",n0={self.n0}"
        resize = f",resize->{self.resize_to}" if self.resize_to else ""
        err = (f",err<={self.err_bound:.3g}"
               if self.family in APPROX_FAMILIES else "")
        if self.cond_bound:
            err += f",cond<={self.cond_bound:.3g}"
        return (f"{self.family}(d={self.d},s={self.s},m={self.m}"
                f"{extra}{err}),{self.schedule},"
                f"{'packed' if self.packed else 'per-leaf'}"
                f"{',pipelined' if self.pipelined else ''}{resize}: "
                f"E[T]={self.predicted_total_s:.3f}s "
                f"(wait {self.predicted_wait_s:.3f} "
                f"+ step {self.predicted_step_s:.4f})")


class StepCostBook:
    """Measured step-cost calibration, load-aware.

    Built from telemetry records with a positive measured wall-clock
    (synthetic windows carry none).  Lookup order for a candidate plan:

    1. **exact**: the mean measurement of the identical scheme
       ``(d, k, loads, schedule, packed)``;
    2. **per-config, per-load**: mean of ``measured / d`` over the
       candidate's ``(schedule, packed)`` config, scaled by the
       candidate's ``d`` — a d=1 candidate is not charged the wall-clock
       of the d=4 step that produced the telemetry;
    3. **global per-load**: the same ratio pooled over every config
       (optimistic for untried schedules, so they can win the ranking and
       get measured next);
    4. 0.0 when no measurements exist at all.

    The book also pools the one-time **compile walls** telemetry reports
    for fresh executables (``StepRecord.compile_s``):
    :meth:`amortized_compile` prices the recompile a candidate would
    trigger, spread over a re-plan horizon — the membership-aware charge
    that keeps the elastic ladder from flapping between stay-degraded and
    resize when the remaining run is too short to earn the recompile back.
    Records predating the field carry ``compile_s = 0.0``, so the default
    (non-elastic) ranking path is unchanged.
    """

    def __init__(self, records: Sequence[StepRecord] = ()):
        """Pool the positive measurements of ``records`` into the book."""
        exact: dict[tuple, list[float]] = {}
        per_cfg: dict[tuple[str, bool], list[float]] = {}
        per_load: list[float] = []
        compiled: set[tuple] = set()
        compile_walls: list[float] = []
        for r in records:
            pipe = bool(getattr(r, "pipelined", False))
            key = (r.d, r.k, tuple(r.loads), r.schedule, r.packed, pipe)
            if getattr(r, "compile_s", 0.0) > 0:
                compile_walls.append(float(r.compile_s))
            if r.measured_step_s > 0:
                compiled.add(key)
                exact.setdefault(key, []).append(r.measured_step_s)
                per_cfg.setdefault((r.schedule, r.packed, pipe), []).append(
                    r.measured_step_s / max(r.d, 1))
                per_load.append(r.measured_step_s / max(r.d, 1))
        self._exact = {k: float(np.mean(v)) for k, v in exact.items()}
        self._per_cfg = {k: float(np.mean(v)) for k, v in per_cfg.items()}
        self._global = float(np.mean(per_load)) if per_load else 0.0
        self._compiled = compiled
        self._compile_wall = (float(np.mean(compile_walls))
                              if compile_walls else 0.0)

    def __len__(self) -> int:
        """Number of exactly-measured scheme signatures."""
        return len(self._exact)

    @property
    def compile_wall_s(self) -> float:
        """Mean observed one-time trace+compile wall (0.0 if never seen)."""
        return self._compile_wall

    def cost(self, d: int, k: int, loads: tuple[int, ...], schedule: str,
             packed: bool, pipelined: bool = False) -> float:
        """Predicted measured-step seconds for a candidate scheme."""
        key = (d, k, tuple(loads), schedule, packed, bool(pipelined))
        if key in self._exact:
            return self._exact[key]
        cfg = self._per_cfg.get((schedule, packed, bool(pipelined)))
        return (cfg if cfg is not None else self._global) * max(d, 1)

    def amortized_compile(self, d: int, k: int, loads: tuple[int, ...],
                          schedule: str, packed: bool,
                          pipelined: bool = False,
                          horizon: int = 200) -> float:
        """Per-step recompile charge for switching to a candidate scheme.

        A scheme already measured is warm in the Trainer's executable
        cache — switching back is free.  An unseen scheme pays the pooled
        mean compile wall spread over ``horizon`` steps (the expected
        steps until the next re-plan).  With no compile observations the
        charge is 0.0 — the ranking degrades gracefully to cost-blind.
        """
        key = (d, k, tuple(loads), schedule, packed, bool(pipelined))
        if key in self._compiled or self._compile_wall <= 0:
            return 0.0
        return self._compile_wall / max(int(horizon), 1)


def step_cost_book(records: Sequence[StepRecord]) -> StepCostBook:
    """Build the :class:`StepCostBook` calibration from a telemetry window."""
    return StepCostBook(records)


def _approx_wait(params, d: int, t: int, m: int, npts: int) -> float:
    """Analytic E[T_tot] of an approx candidate dropping the slowest ``t``.

    Same Sec-VI order-statistic integral as the uniform scheme
    (:func:`~repro.core.runtime_model.expected_total_runtime`) — but
    composed directly, because that helper enforces the exact-decode
    frontier ``s <= d - m``, which an approximate drop budget deliberately
    exceeds (the decode stays well-defined at any budget, just certified
    rather than exact).
    """
    return (d * params.t1 + params.t2 / m
            + expected_order_stat(params, d, t, m, npts=npts))


def _hetero_wait(fit: FitResult, loads, k: int, s: int, m: int,
                 mc_iters: int, seed: int,
                 departed: Sequence[int] = ()) -> float:
    """Monte-Carlo mean wait of a hetero plan under the fitted model,
    including the per-worker shift constants (comparable to E[T_tot]).

    ``departed`` workers never respond (modeled time ``+inf``); the wait
    is finite only while the drop budget ``s`` covers them.  When the
    plan's worker count differs from the fit's (a resize candidate), the
    fitted model is re-shaped positionally: retained workers keep their
    fitted speeds, brand-new workers get speed 1, and the vector is
    re-normalised to mean 1.
    """
    n_plan = len(loads)
    params = fit.params
    speeds = np.asarray(fit.speeds, dtype=np.float64)
    if n_plan != params.n:
        params = dataclasses.replace(params, n=n_plan)
        if speeds.shape[0] >= n_plan:
            speeds = speeds[:n_plan]
        else:
            speeds = np.concatenate(
                [speeds, np.ones(n_plan - speeds.shape[0])])
        speeds = speeds / max(float(speeds.mean()), 1e-12)
    pats = draw_patterns_hetero(params, loads, k, s, m, mc_iters,
                                speeds=speeds, seed=seed,
                                departed=tuple(departed))
    return mean_wait_s(pats)


def score_plan(fit: FitResult, plan: Plan,
               cost_book: StepCostBook | None = None,
               mc_iters: int = 400, npts: int = 20_000,
               seed: int = 0,
               departed: Sequence[int] = ()) -> Plan:
    """Re-score an existing plan under a (new) fit: returns a copy with
    fresh ``predicted_*`` fields.

    The control loop uses this to price the *active* plan against the
    ranked candidates even when the active scheme falls outside the
    current search space (e.g. a hetero plan after the fitted speed
    spread dropped back below the threshold) — hysteresis must always
    compare against a like-for-like prediction, never default to
    switching.

    ``departed`` (elastic membership) marks workers that never respond:
    any uniform plan is then priced by the same Monte-Carlo order
    statistic the hetero family uses, with the departed workers' times
    pinned to ``+inf`` — a plan whose drop budget cannot cover the
    departures prices to ``inf`` and can never win hysteresis.  Indices
    outside the plan's worker range are ignored (they refer to workers a
    resize already removed).  A departed pipelined plan is priced with
    the synchronous model (conservative: overlap can only help).
    """
    book = cost_book or StepCostBook()
    n_plan = len(plan.loads)
    dep = tuple(sorted({int(i) for i in departed if 0 <= int(i) < n_plan}))
    if (plan.family == "uniform" or plan.family in APPROX_FAMILIES
            or plan.family in STABLE_FAMILIES) and not dep:
        params = (fit.params if n_plan == fit.params.n
                  else dataclasses.replace(fit.params, n=n_plan))
        if plan.pipelined:
            # overlapped steady state: per-worker cycle max(comp, comm)
            wait = expected_total_runtime_overlapped(
                params, plan.d, plan.s, plan.m, npts=npts,
                eps=PIPELINE_EPS)
        elif plan.family in APPROX_FAMILIES:
            # approx drop budgets may exceed the exact-decode frontier
            wait = _approx_wait(params, plan.d, plan.s, plan.m, npts)
        else:
            wait = expected_total_runtime(params, plan.d, plan.s, plan.m,
                                          npts=npts)
    else:
        wait = _hetero_wait(fit, plan.loads, plan.k, plan.s, plan.m,
                            mc_iters, seed, departed=dep)
    step = book.cost(plan.d, plan.k, plan.loads, plan.schedule, plan.packed,
                     plan.pipelined)
    return dataclasses.replace(plan, predicted_wait_s=wait,
                               predicted_step_s=step,
                               predicted_total_s=wait + step)


def rank_plans(fit: FitResult, *,
               schedules: Sequence[str] = ("gather", "a2a"),
               families: Sequence[str] = ("uniform",),
               packed_options: Sequence[bool] = (True,),
               pipelined_options: Sequence[bool] = (False,),
               cost_book: StepCostBook | None = None,
               min_s: int = 0,
               hetero_threshold: float = 1.15,
               hetero_k_factor: int = 4,
               mc_iters: int = 400,
               npts: int = 20_000,
               seed: int = 0,
               departed: Sequence[int] = (),
               resize_options: Sequence[int] = (),
               replan_horizon: int = 200,
               amortize_compile: bool = False,
               approx_options: Sequence[str] = (),
               max_err: float | None = None,
               stable_options: Sequence[str] = (),
               max_cond: float | None = None) -> list[Plan]:
    """Score and rank every reachable plan under a fitted straggler model.

    ``min_s`` floors the straggler budget (a production cluster usually
    insists on ``s >= 1`` even when the model momentarily says stragglers
    are cheap).  ``hetero_threshold`` gates the hetero family on the fitted
    ``speed_spread``; ``"hetero!"`` in ``families`` forces it regardless.
    ``pipelined_options`` adds async double-buffered candidates whose wait
    is the *overlapped* steady-state model — per-worker cycle
    ``max(compute, comm)`` plus :data:`PIPELINE_EPS`
    (:func:`~repro.core.runtime_model.expected_total_runtime_overlapped`);
    pipelining is a uniform-family knob (the hetero runtime stays
    synchronous).  Ties (e.g. two schedules with no measurements yet) break
    deterministically toward the earlier entry in ``schedules`` /
    ``packed_options`` / ``pipelined_options``.

    **Elastic membership** (all default-off, so the classic ranking is
    bit-identical when unused):

    - ``departed`` — workers that never respond.  Every same-``n``
      candidate is then priced by the Monte-Carlo order statistic with
      those workers pinned to ``+inf`` (a budget that cannot cover them
      prices to ``inf``), and the hetero family additionally offers
      *stay-degraded* candidates: zero load at the departed indices via
      :func:`~repro.core.hetero.plan_hetero`, restoring exact decode at
      unchanged ``n``.  Same-``n`` pipelined candidates are suppressed —
      the pipelined runtime cannot fail over per-step, and pricing
      overlap with a permanent hole is not modeled.
    - ``resize_options`` — alternative cluster sizes (e.g. ``n_alive``)
      to price as uniform candidates, marked ``resize_to``.  A resize
      candidate always pays :meth:`StepCostBook.amortized_compile` — the
      mesh rebuild forces a retrace — amortized over ``replan_horizon``
      steps, so a short horizon keeps the cluster on the degraded rung.
    - ``amortize_compile=True`` extends the recompile charge to every
      candidate (scheme switches also retrace); off by default to keep
      the classic autotuner ranking unchanged.

    **Approximate families** (``approx_options``, default off): every
    valid ``"frc"`` / ``"expander"`` construction at ``n`` workers
    (:func:`~repro.core.approx.approx_candidates`) is priced at the
    *largest* drop budget ``t`` whose worst-case decode-error certificate
    clears the ceiling — ``worst_err_bound(t) <= max_err`` — so bounded
    error buys a shorter wait (the master only waits for the fastest
    ``n - t``).  A candidate enters the ranking **iff** its bound clears
    the ceiling: ``max_err=None`` (or 0.0) admits only certified-exact
    operating points (``err_bound == 0``), a negative ceiling admits
    none, and every returned approx plan carries its certificate in
    ``Plan.err_bound``.  Approx runtimes decode through the partial path
    (the trainer compiles ``partial=True`` artifacts for them), which is
    synchronous — no pipelined approx candidates.

    **Stable families and the condition gate** (``stable_options`` /
    ``max_cond``, default off): every *certified* construction of the
    requested :data:`~repro.core.stable.STABLE_FAMILIES` enters the search
    with the same exact-decode frontier and wait model as the uniform
    family, carrying its certified worst-|F| ``cond(V_F V_F^T)`` in
    ``Plan.cond_bound`` (closed-form/enumerated for ``chebyshev`` /
    ``rotation``, per-block for ``block`` composites — see
    :func:`repro.core.stable.certified_max_cond`).  A candidate is
    admitted **iff** its certificate clears the ceiling:
    ``cond_bound <= max_cond``, with ``max_cond=None`` meaning "any finite
    certificate" (uncertified constructions — certificate ``inf`` — are
    never admitted).  When ``max_cond`` is set it also gates the *uniform*
    family: classic poly/random candidates are certified by exhaustive
    small-n enumeration
    (:func:`~repro.core.stable.classic_certified_cond`) and rejected past
    the ceiling — at large n that enumeration is honestly ``inf``, which
    is exactly the regime where the gate must steer the search to the
    stable families.  With ``max_cond=None`` the uniform family is ungated
    (the classic ranking is bit-identical when both knobs are unused).
    """
    n = fit.params.n
    book = cost_book or StepCostBook()
    dep = tuple(sorted({int(i) for i in departed if 0 <= int(i) < n}))

    candidates: list[tuple] = []     # (total, tiebreak, Plan)
    sched_rank = {sc: i for i, sc in enumerate(schedules)}
    packed_rank = {pk: i for i, pk in enumerate(packed_options)}
    pipe_rank = {pi: i for i, pi in enumerate(pipelined_options)}

    def add(family, d, s, m, k, loads, waits, resize_to=None,
            charge_compile=False, err_bound=0.0, cond_bound=0.0, n0=None):
        # waits: {pipelined_flag: modeled wait} for the flags this scheme
        # supports (hetero and approx pass only {False: ...})
        for schedule in schedules:
            for packed in packed_options:
                for pipelined, wait in waits.items():
                    if pipelined not in pipe_rank:
                        continue   # scheme doesn't support this flag
                    step = book.cost(d, k, loads, schedule, packed,
                                     pipelined)
                    if charge_compile or amortize_compile:
                        step += book.amortized_compile(
                            d, k, loads, schedule, packed, pipelined,
                            horizon=replan_horizon)
                    candidates.append((
                        wait + step,
                        (0 if resize_to is None else 1,
                         sched_rank[schedule], packed_rank[packed],
                         pipe_rank[pipelined]),
                        Plan(family=family, d=d, s=s, m=m, k=k, loads=loads,
                             schedule=schedule, packed=packed,
                             predicted_wait_s=wait, predicted_step_s=step,
                             predicted_total_s=wait + step,
                             pipelined=pipelined, resize_to=resize_to,
                             err_bound=err_bound, cond_bound=cond_bound,
                             n0=n0)))

    cond_ceiling = float("inf") if max_cond is None else float(max_cond)

    if "uniform" in families:
        for d in range(1, n + 1):
            for m in range(1, d + 1):
                s = d - m
                if s < min_s:
                    continue
                cond = 0.0
                if max_cond is not None:
                    # the gate is on: certify the classic construction's
                    # worst-|F| conditioning (exact small-n enumeration,
                    # honestly inf at large n) and reject past the ceiling.
                    # seed 0 = make_code's default — the code the trainer
                    # would materialise for this plan
                    cond = classic_certified_cond(n, s)
                    if not cond <= cond_ceiling:
                        continue
                waits = {}
                for pipelined in pipelined_options:
                    if pipelined:
                        if dep:
                            continue  # no per-step failover when pipelined
                        waits[True] = expected_total_runtime_overlapped(
                            fit.params, d, s, m, npts=npts,
                            eps=PIPELINE_EPS)
                    elif dep:
                        if s < len(dep):
                            continue  # cannot cover the departures: inf
                        waits[False] = _hetero_wait(
                            fit, (d,) * n, n, s, m, mc_iters, seed,
                            departed=dep)
                    else:
                        waits[False] = expected_total_runtime(
                            fit.params, d, s, m, npts=npts)
                add("uniform", d, s, m, n, (d,) * n, waits,
                    cond_bound=cond)

    want_hetero = ("hetero!" in families
                   or ("hetero" in families
                       and fit.speed_spread >= hetero_threshold)
                   or bool(dep))   # stay-degraded rung needs the family
    if want_hetero:
        k = hetero_k_factor * n
        for r in range(2, n + 1):            # replication s + m
            for m in range(1, r + 1):
                s = r - m
                if s < max(min_s, 1, len(dep)):
                    continue                  # hetero needs a real budget
                try:
                    plan = plan_hetero(fit.speeds, s, m, k=k, departed=dep)
                except ValueError:
                    continue
                wait = _hetero_wait(fit, plan.loads, plan.k, s, m,
                                    mc_iters, seed, departed=dep)
                add("hetero", max(plan.loads), s, m, plan.k,
                    tuple(plan.loads), {False: wait},
                    charge_compile=bool(dep))

    for fam in approx_options:
        if fam not in APPROX_FAMILIES:
            raise ValueError(
                f"unknown approx family {fam!r}; expected one of "
                f"{APPROX_FAMILIES}")
        ceiling = 0.0 if max_err is None else float(max_err)
        # expander graphs use the fixed default seed (0): the trainer must
        # rebuild the exact graph that was ranked, across replans
        for rep, m, code in approx_candidates(fam, n):
            # largest drop budget whose worst-case certificate clears the
            # ceiling: more drops always shorten the wait, and the bound is
            # monotone in t, so search from the top.  A candidate is added
            # iff some budget (possibly the exact region) clears.
            t_pick, bound = None, 0.0
            for t in range(n - 1, -1, -1):
                b = code.worst_err_bound(t)
                if b <= ceiling:
                    t_pick, bound = t, b
                    break
            if t_pick is None:
                continue
            if dep:
                if t_pick < len(dep):
                    continue      # cannot cover the departures: inf wait
                wait = _hetero_wait(fit, code.loads, code.num_subsets,
                                    t_pick, m, mc_iters, seed, departed=dep)
            else:
                wait = _approx_wait(fit.params, code.d, t_pick, m, npts)
            add(fam, code.d, t_pick, m, code.num_subsets, code.loads,
                {False: wait}, err_bound=bound)

    for fam in stable_options:
        if fam not in STABLE_FAMILIES:
            raise ValueError(
                f"unknown stable family {fam!r}; expected one of "
                f"{STABLE_FAMILIES}")
        # rotation bases use the fixed default seed (0): the trainer must
        # rebuild the exact construction that was ranked, across replans
        for d, s, m, n0, cond in stable_candidates(fam, n):
            if s < min_s:
                continue
            if not cond <= cond_ceiling:
                continue    # admission iff the certificate clears the gate
            waits = {}
            for pipelined in pipelined_options:
                if pipelined:
                    if dep:
                        continue  # no per-step failover when pipelined
                    waits[True] = expected_total_runtime_overlapped(
                        fit.params, d, s, m, npts=npts, eps=PIPELINE_EPS)
                elif dep:
                    if s < len(dep):
                        continue  # cannot cover the departures: inf
                    waits[False] = _hetero_wait(
                        fit, (d,) * n, n, s, m, mc_iters, seed,
                        departed=dep)
                else:
                    waits[False] = expected_total_runtime(
                        fit.params, d, s, m, npts=npts)
            add(fam, d, s, m, n, (d,) * n, waits, cond_bound=cond, n0=n0)

    for new_n in resize_options:
        new_n = int(new_n)
        if new_n < 1 or new_n == n:
            continue
        for d in range(1, new_n + 1):
            for m in range(1, d + 1):
                s = d - m
                if s < min_s:
                    continue
                loads = (d,) * new_n
                wait = _hetero_wait(fit, loads, new_n, s, m,
                                    mc_iters, seed)
                add("uniform", d, s, m, new_n, loads, {False: wait},
                    resize_to=new_n, charge_compile=True)

    candidates.sort(key=lambda c: (c[0], c[1]))
    return [c[2] for c in candidates]
