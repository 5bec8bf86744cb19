"""Online straggler profiling and adaptive (d, s, m) auto-tuning (numpy
copies of the reference's ``repro.tune`` modules, pinned against their
sources by the tests), and the straggler sources shared by training and
serving.

  telemetry — per-step, per-worker compute/communication durations
              (`StepRecord` / `TelemetryLog`) and the shifted-exponential
              injectors (`ShiftedExpSampler`, `DriftingSampler`)
  estimator — closed-form MLE of the Section-VI constants
              (`fit_runtime_params`), cross-checked against the
              order-statistic math (`crosscheck_waits`)
  planner   — ranked search of (d, s, m) x schedule x family by predicted
              step time, calibrated with measured step times (`rank_plans`)
  policy    — the control loop (`AutotunePolicy`, `Autotuner`)
  stragglers— the `StragglerSource` protocol (none / fixed / random / timed)
  arrivals  — the serving-side planner: Poisson arrivals, queue simulation,
              p99 ranking and the `ServingAutotuner` loop

Entry points: ``Trainer(..., autotune=AutotunePolicy(...),
straggler_source=DriftingSampler(...))`` records telemetry, re-plans on the
policy's cadence and swaps codecs through a per-scheme artifact cache, so
returning to a scheme rebuilds nothing; ``CodedServer(...,
autotune=ServingPolicy(...))`` is the serving twin, ranking by modeled p99
under the arrival process.
"""
from .arrivals import (PoissonArrivals, ServePlan, ServingAutotuner,
                       ServingPolicy, rank_serving_plans, simulate_queue)
from .estimator import (FitResult, crosscheck_waits, fit_runtime_params,
                        fit_shifted_exponential, synthetic_fit)
from .planner import (PIPELINE_EPS, Plan, StepCostBook, rank_plans,
                      score_plan, step_cost_book)
from .policy import AutotunePolicy, Autotuner
from .stragglers import (FixedStragglers, NoStragglers, RandomStragglers,
                         StragglerDraw, StragglerSource, TimedSource,
                         as_straggler_source)
from .telemetry import (DriftingSampler, ShiftedExpSampler, StepRecord,
                        TelemetryLog, WorkerTimes, record_from_times,
                        scheme_k, scheme_loads)

__all__ = [
    "AutotunePolicy",
    "Autotuner",
    "DriftingSampler",
    "FitResult",
    "FixedStragglers",
    "NoStragglers",
    "PIPELINE_EPS",
    "Plan",
    "PoissonArrivals",
    "RandomStragglers",
    "ServePlan",
    "ServingAutotuner",
    "ServingPolicy",
    "ShiftedExpSampler",
    "StepCostBook",
    "StepRecord",
    "StragglerDraw",
    "StragglerSource",
    "TelemetryLog",
    "TimedSource",
    "WorkerTimes",
    "as_straggler_source",
    "crosscheck_waits",
    "fit_runtime_params",
    "fit_shifted_exponential",
    "rank_plans",
    "rank_serving_plans",
    "record_from_times",
    "scheme_k",
    "scheme_loads",
    "score_plan",
    "simulate_queue",
    "step_cost_book",
    "synthetic_fit",
]
