"""MLE fit of the Section-VI straggler model from step telemetry.

The paper's runtime model is two independent shifted exponentials: per-subset
computation ``T1 = t1 + Exp(lambda1)`` and full-vector communication
``T2 = t2 + Exp(lambda2)`` (``repro.core.runtime_model``).  A
:class:`~repro.tune.telemetry.StepRecord` observes, per worker ``i``,

    compute_i = scale_i * T1_i,   scale_i = loads_i * n / k   (d for uniform)
    comm_i    = T2_i / m

so dividing by the known scheme factors recovers i.i.d. samples of ``T1``
and ``T2``, and the shifted-exponential MLE is closed-form:

    t_hat      = min(x)                       (the shift is a hard floor)
    lambda_hat = 1 / (mean(x) - min(x))

(:func:`fit_shifted_exponential`; the min is the classical MLE of the
location and is biased high by ``1/(N*lambda)`` — negligible at the window
sizes the tuner runs, and covered by the round-trip property test's
tolerance).

Heterogeneity: per-worker relative speeds multiply the whole compute term,
so :func:`fit_runtime_params` first estimates ``speed_i`` as the pooled
mean of the normalised compute samples over worker ``i``'s own mean, then
fits the pooled, speed-corrected samples.  On a homogeneous cluster the
estimated speeds fluctuate around 1 by ordinary sampling noise.

:func:`crosscheck_waits` closes the loop against the order-statistic math:
the fitted model's analytic ``E[T_tot]`` (``expected_total_runtime``) is
compared to the empirically observed mean master wait per scheme in the
window — the control loop rejects fits whose cross-check error exceeds
``AutotunePolicy.max_crosscheck_rel_err`` instead of re-planning on them.

>>> import numpy as np
>>> rng = np.random.default_rng(0)
>>> x = 2.0 + rng.exponential(1 / 4.0, 4000)
>>> t, lam = fit_shifted_exponential(x)
>>> bool(abs(t - 2.0) < 0.05 and abs(lam - 4.0) / 4.0 < 0.1)
True
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.runtime_model import RuntimeParams, expected_total_runtime

from .telemetry import StepRecord

_MIN_RATE_SPREAD = 1e-9


def fit_shifted_exponential(samples: np.ndarray | Sequence[float],
                            ) -> tuple[float, float]:
    """Closed-form MLE ``(t_hat, lambda_hat)`` for ``x ~ t + Exp(lambda)``.

    Requires at least two samples; degenerate (near-constant) samples clamp
    the rate to a large finite value instead of overflowing.
    """
    x = np.asarray(samples, dtype=np.float64)
    if x.size < 2:
        raise ValueError(f"need >= 2 samples to fit, got {x.size}")
    t_hat = float(x.min())
    spread = float(x.mean() - t_hat)
    lam_hat = 1.0 / max(spread, _MIN_RATE_SPREAD)
    return t_hat, lam_hat


@dataclasses.dataclass(frozen=True)
class FitResult:
    """A fitted straggler model: shifted-exp constants + speed vector.

    ``params`` packages ``(t1, lambda1, t2, lambda2)`` as the
    :class:`~repro.core.runtime_model.RuntimeParams` every Section-VI
    helper consumes; ``speeds`` is the per-worker relative compute speed
    estimate (all ~1 on a homogeneous cluster), normalised to mean 1.
    """

    params: RuntimeParams
    speeds: np.ndarray          # (n,) relative compute speeds, mean 1
    n_steps: int                # records the fit consumed
    n_samples: int              # per-worker samples pooled per term

    @property
    def speed_spread(self) -> float:
        """max/min of the estimated speeds — the planner's hetero trigger."""
        lo = float(self.speeds.min())
        return float(self.speeds.max()) / max(lo, 1e-12)


def _compute_scales(rec: StepRecord) -> np.ndarray:
    """(n,) factor mapping per-subset T1 to worker compute: loads*n/k."""
    loads = np.asarray(rec.loads, dtype=np.float64)
    return loads * rec.n / rec.k


def fit_runtime_params(records: Sequence[StepRecord]) -> FitResult:
    """Fit ``(t1, lambda1, t2, lambda2)`` + per-worker speeds from a window.

    Records may span different schemes (the tuner switches codecs
    mid-window): each record's timings are normalised by its own scheme
    factors before pooling.  Zero-load workers contribute no compute
    samples (their modeled compute time is 0).
    """
    records = list(records)
    if not records:
        raise ValueError("empty telemetry window")
    n = records[0].n
    if any(r.n != n for r in records):
        raise ValueError("telemetry window mixes worker counts")

    comp_rows, comm_rows, valid_rows = [], [], []
    for r in records:
        scale = _compute_scales(r)
        valid = scale > 0
        row = np.zeros(n)
        row[valid] = np.asarray(r.compute_s, dtype=np.float64)[valid] \
            / scale[valid]
        comp_rows.append(row)
        valid_rows.append(valid)
        comm_rows.append(np.asarray(r.comm_s, dtype=np.float64) * r.m)
    comp = np.stack(comp_rows)          # (steps, n) per-subset T1 samples
    valid = np.stack(valid_rows)        # (steps, n) load > 0 mask
    comm = np.stack(comm_rows)          # (steps, n) T2 samples

    # per-worker speed: pooled mean over the worker's own mean (workers that
    # never held a subset in the window get speed 1 — nothing to estimate)
    counts = valid.sum(axis=0)
    sums = (comp * valid).sum(axis=0)
    pooled_mean = float(sums.sum() / max(counts.sum(), 1))
    worker_mean = np.where(counts > 0, sums / np.maximum(counts, 1),
                           pooled_mean)
    speeds = pooled_mean / np.maximum(worker_mean, 1e-12)
    speeds = speeds / speeds.mean()

    # speed-corrected pooling: compute_i * speed_i ~ t1 + Exp(lambda1)
    t1, lam1 = fit_shifted_exponential((comp * speeds[None, :])[valid])
    t2, lam2 = fit_shifted_exponential(comm.ravel())
    return FitResult(
        params=RuntimeParams(n=n, lambda1=lam1, lambda2=lam2, t1=t1, t2=t2),
        speeds=speeds, n_steps=len(records), n_samples=int(valid.sum()))


def crosscheck_waits(fit: FitResult, records: Sequence[StepRecord],
                     npts: int = 20_000) -> float:
    """Worst relative error of the fitted model's ``E[T_tot]`` vs observed.

    Groups the window by uniform scheme triple, compares the analytic
    expectation under the fitted params
    (:func:`~repro.core.runtime_model.expected_total_runtime` — the
    order-statistic integral) with the empirical mean of the observed
    ``wait_s``, and returns the worst relative error across triples.
    Heterogeneous-load records are skipped (no closed form; the planner
    scores those by Monte Carlo instead).
    """
    groups: dict[tuple[int, int, int], list[float]] = {}
    for r in records:
        if len(set(r.loads)) != 1 or r.k != r.n:
            continue
        groups.setdefault((r.d, r.s, r.m), []).append(r.wait_s)
    worst = 0.0
    for (d, s, m), waits in groups.items():
        analytic = expected_total_runtime(fit.params, d, s, m, npts=npts)
        observed = float(np.mean(waits))
        worst = max(worst, abs(analytic - observed) / max(analytic, 1e-12))
    return worst


def synthetic_fit(params: RuntimeParams,
                  speeds: Sequence[float] | None = None,
                  steps: int = 64, seed: int = 0,
                  probe: tuple[int, int, int] = (1, 0, 1)) -> FitResult:
    """Fit from a synthetic telemetry window drawn from known ground truth.

    Samples ``steps`` records under a fixed probe scheme ``(d, s, m)`` with
    the stationary :class:`~repro.tune.telemetry.ShiftedExpSampler` and
    runs :func:`fit_runtime_params` on them.  This is the cluster-free
    entry: the dry-run's ``autotune`` lever and the quickstart use it to
    exercise the measure->fit->plan loop without real worker heartbeats.
    """
    from .telemetry import ShiftedExpSampler, StepRecord as _SR
    d, s, m = probe
    n = params.n
    sampler = ShiftedExpSampler(params, speeds, seed=seed)
    records = []
    for t in range(steps):
        wt = sampler.draw((d,) * n, n, m)
        slow, wait = wt.order_stat(s)
        records.append(_SR(step=t, d=d, s=s, m=m, k=n, loads=(d,) * n,
                           schedule="gather", packed=True,
                           compute_s=wt.compute_s, comm_s=wt.comm_s,
                           stragglers=slow, wait_s=wait))
    return fit_runtime_params(records)
