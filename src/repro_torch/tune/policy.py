"""The autotune control loop: when to fit, when to re-plan, when to switch.

:class:`AutotunePolicy` is the declarative knob set a caller hands to
``Trainer(autotune=...)``; :class:`Autotuner` is the state machine that owns
the telemetry log and drives measure -> fit -> plan -> (maybe) switch:

1. every step the Trainer appends a
   :class:`~repro.tune.telemetry.StepRecord`;
2. every ``interval`` steps, once ``min_samples`` records exist, the tuner
   fits the shifted-exponential model on the last ``window`` records
   (:func:`~repro.tune.estimator.fit_runtime_params`) and ranks the
   reachable plans (:func:`~repro.tune.planner.rank_plans`) with the
   measured step-cost calibration;
3. fits whose cross-check error (fitted E[T_tot] vs the observed waits in
   the window) exceeds ``max_crosscheck_rel_err`` are rejected outright —
   a model that cannot predict its own training window must not drive a
   codec switch;
4. the top plan replaces the active one only when its predicted total beats
   the active plan's *re-scored* prediction by more than ``switch_margin``
   (hysteresis: re-planning must not flap between near-equal schemes on
   sampling noise).  The active plan is re-scored under the new fit even
   when it falls outside the current search space
   (:func:`~repro.tune.planner.score_plan`), so hysteresis always compares
   like for like.

Every decision — fit constants, cross-check error, ranked head, switch or
hold — is appended to ``Autotuner.events`` for the bench/docs to render.
"""
from __future__ import annotations

import dataclasses

from .estimator import crosscheck_waits, fit_runtime_params
from .planner import Plan, rank_plans, score_plan, step_cost_book
from .telemetry import StepRecord, TelemetryLog


@dataclasses.dataclass(frozen=True)
class AutotunePolicy:
    """Declarative configuration of the online (d, s, m) auto-tuner."""

    interval: int = 20              # re-plan every N steps
    window: int = 64                # telemetry records per fit
    min_samples: int = 8            # records required before the first fit
    schedules: tuple[str, ...] = ("gather", "a2a")
    families: tuple[str, ...] = ("uniform",)   # + "hetero" / "hetero!"
    packed_options: tuple[bool, ...] = (True,)
    pipelined_options: tuple[bool, ...] = (False,)  # + True: async stale-1
    min_s: int = 0                  # floor on the straggler budget
    hetero_threshold: float = 1.15  # speed spread unlocking hetero plans
    switch_margin: float = 0.03     # min relative predicted gain to swap
    max_crosscheck_rel_err: float = 1.0  # reject fits worse than this
    mc_iters: int = 400             # Monte-Carlo draws per hetero candidate
    npts: int = 20_000              # integration grid for E[T_tot]
    seed: int = 0
    #: elastic membership: cluster sizes to price as resize candidates
    #: when workers have departed.  Entries <= 0 are relative to the
    #: alive count (0 = "resize to n_alive", -1 = one fewer); positive
    #: entries are absolute sizes.  Every resize candidate pays the
    #: recompile charge amortized over ``replan_horizon`` steps.
    #: Empty = never propose a resize.
    resize_options: tuple[int, ...] = ()
    replan_horizon: int = 200       # steps the recompile charge spreads over
    #: approximate-decode families to rank ("frc" / "expander"); empty =
    #: exact-only search.  ``max_err`` is the worst-case decode-error
    #: certificate ceiling a candidate's drop budget must clear
    #: (None admits only certified-exact approx operating points).
    approx_options: tuple[str, ...] = ()
    max_err: float | None = None


class Autotuner:
    """Owns telemetry + fit/plan state; decides codec switches.

    Decoupled from the Trainer so benches and tests can drive it with
    synthetic records: ``record()`` then ``maybe_replan()`` per step.
    """

    def __init__(self, policy: AutotunePolicy, current: Plan | None = None):
        """``current`` seeds the active plan (the Trainer's initial codec)."""
        self.policy = policy
        self.telemetry = TelemetryLog(capacity=max(4 * policy.window, 256))
        self.current = current
        self.events: list[dict] = []
        self.last_fit = None
        self._steps_since_plan = 0

    def record(self, rec: StepRecord) -> None:
        """Ingest one step's telemetry."""
        self.telemetry.append(rec)
        self._steps_since_plan += 1

    def due(self) -> bool:
        """True when the next ``maybe_replan`` call will actually fit."""
        return (self._steps_since_plan >= self.policy.interval
                and len(self.telemetry) >= self.policy.min_samples)

    def maybe_replan(self, step: int,
                     departed: tuple[int, ...] = ()) -> Plan | None:
        """Fit + rank when due; return the new plan iff a switch is called.

        Returns ``None`` both when not yet due and when the ranking keeps
        the active plan (the hold decision is still logged to ``events``).

        ``departed`` (elastic membership) names workers that never
        respond: the ranking prices every same-``n`` candidate with those
        workers pinned unresponsive, offers stay-degraded hetero
        candidates (zero load at the departed indices), and — when the
        policy carries ``resize_options`` — prices resize candidates with
        the recompile charge amortized over ``replan_horizon``.  The
        active plan's hysteresis re-score sees the same departed set, so
        a degraded incumbent is priced at its true (departed-aware) cost.
        """
        p = self.policy
        if not self.due():
            return None
        self._steps_since_plan = 0
        window = self.telemetry.window(p.window)
        fit = fit_runtime_params(window)
        self.last_fit = fit
        xcheck = crosscheck_waits(fit, window, npts=min(p.npts, 20_000))
        event = {
            "step": step,
            "fit": {"t1": fit.params.t1, "lambda1": fit.params.lambda1,
                    "t2": fit.params.t2, "lambda2": fit.params.lambda2,
                    "speed_spread": fit.speed_spread,
                    "n_steps": fit.n_steps},
            "crosscheck_rel_err": xcheck,
        }
        if xcheck > p.max_crosscheck_rel_err:
            # the documented refusal: a fit that cannot even predict the
            # waits it was trained on must not drive a codec switch (a
            # lenient default — mixed windows straddling a genuine drift
            # legitimately cross-check worse than stationary ones).  The
            # event keeps the full key set so consumers can index
            # uniformly; no ranking ran, so "best" is None.
            event.update(rejected_fit=True, switched=False, best=None,
                         current_predicted_s=None)
            self.events.append(event)
            return None
        book = step_cost_book(window)
        dep = tuple(sorted({int(i) for i in departed
                            if 0 <= int(i) < fit.params.n}))
        resize: list[int] = []
        if dep:
            n_alive = fit.params.n - len(dep)
            for r in p.resize_options:
                new_n = n_alive + int(r) if r <= 0 else int(r)
                if 1 <= new_n != fit.params.n and new_n not in resize:
                    resize.append(new_n)
        ranked = rank_plans(
            fit, schedules=p.schedules, families=p.families,
            packed_options=p.packed_options,
            pipelined_options=p.pipelined_options,
            cost_book=book, min_s=p.min_s,
            hetero_threshold=p.hetero_threshold, mc_iters=p.mc_iters,
            npts=p.npts, seed=p.seed + step,
            departed=dep, resize_options=tuple(resize),
            replan_horizon=p.replan_horizon,
            approx_options=p.approx_options, max_err=p.max_err)
        if not ranked:
            return None
        best = ranked[0]
        current_pred = None
        if self.current is not None:
            for cand in ranked:
                if cand.scheme_key == self.current.scheme_key:
                    current_pred = cand.predicted_total_s
                    break
            if current_pred is None:
                # active scheme fell outside the search space (e.g. a
                # hetero plan after the speed spread dropped): re-score it
                # under the same fit so hysteresis still applies instead
                # of defaulting to a switch
                current_pred = score_plan(
                    fit, self.current, cost_book=book, mc_iters=p.mc_iters,
                    npts=p.npts, seed=p.seed + step,
                    departed=dep).predicted_total_s
        switch = (
            self.current is None
            or best.predicted_total_s
            < current_pred * (1.0 - p.switch_margin))
        event.update({
            "best": best.describe(),
            "current_predicted_s": current_pred,
            "switched": bool(switch
                             and (self.current is None
                                  or best.scheme_key
                                  != self.current.scheme_key)),
        })
        if switch and (self.current is None
                       or best.scheme_key != self.current.scheme_key):
            event["from"] = (self.current.describe()
                             if self.current is not None else None)
            self.current = best
            self.events.append(event)
            return best
        self.events.append(event)
        return None
