"""Section VI: probabilistic runtime model and optimal (d, s, m) selection.

Model (paper's assumptions 1-3): per-worker computation time for its d subsets
is ``d * T1_i`` with ``T1_i = t1 + Exp(lambda1)`` i.i.d.; communication time for
an (l/m)-dim vector is ``(1/m) * T2_i`` with ``T2_i = t2 + Exp(lambda2)``; all
independent.  The master waits for the first ``n - s`` workers, so

    T_tot = d*t1 + t2/m + T_{d,s,m},

where ``T_{d,s,m}`` is the (n-s)-th order statistic of n i.i.d. copies of
``X + Y``, X ~ Exp(lambda1/d), Y ~ Exp(m*lambda2)  (paper eq. 27-29).

We compute E[T_tot] by integrating the survival function of the order
statistic — mathematically identical to the paper's eq. (29) but numerically
friendlier — and cross-check against the closed forms of the two extreme
regimes (Propositions 1 and 2) in tests.  The paper's n=8 numeric table is
reproduced to 4 decimals by ``benchmarks/bench_runtime_model.py``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class RuntimeParams:
    """Shifted-exponential model constants (paper Table in Sec. VI-A).

    Per-subset computation time is ``t1 + Exp(lambda1)``; full ``l``-dim
    communication time is ``t2 + Exp(lambda2)`` — both i.i.d. across the
    ``n`` workers.  These four constants fully determine the optimal
    ``(d, s, m)`` triple; at runtime they are *fitted* from telemetry by
    ``repro.tune.fit_runtime_params`` (which returns this class).
    """
    n: int
    lambda1: float  # computation straggling rate
    lambda2: float  # communication straggling rate
    t1: float       # minimum computation time per subset
    t2: float       # minimum communication time for an l-dim vector


def hypoexp_cdf(t: np.ndarray, a: float, b: float) -> np.ndarray:
    """CDF of X + Y, X ~ Exp(a), Y ~ Exp(b) (paper eq. 27).  Handles a == b."""
    t = np.asarray(t, dtype=np.float64)
    if abs(a - b) < 1e-12 * max(a, b):
        x = a * t
        return -np.expm1(-x) - x * np.exp(-x)
    return 1.0 - (a / (a - b)) * np.exp(-b * t) - (b / (b - a)) * np.exp(-a * t)


def _order_stat_mean(cdf_vals: np.ndarray, grid: np.ndarray, n: int, r: int) -> float:
    """E[r-th smallest of n i.i.d.] = ∫ (1 - F_(r)(t)) dt for nonneg supports.

    F_(r)(t) = P(at least r of n below t) = sum_{i=r}^n C(n,i) F^i (1-F)^{n-i},
    evaluated stably via the regularized incomplete beta identity's series.
    """
    F = np.clip(cdf_vals, 0.0, 1.0)
    # survival of the order statistic
    S = np.zeros_like(F)
    for i in range(0, r):  # P(fewer than r below t)
        S += math.comb(n, i) * F**i * (1.0 - F) ** (n - i)
    return float(np.trapezoid(S, grid))


def expected_order_stat(params: RuntimeParams, d: int, s: int, m: int,
                        npts: int = 200_000) -> float:
    """E[T_{d,s,m}] — the (n-s)-th order statistic of the random parts."""
    a, b = params.lambda1 / d, m * params.lambda2
    rate = min(a, b)
    t_hi = (math.log(max(params.n, 2)) + 45.0) / rate
    grid = np.linspace(0.0, t_hi, npts)
    F = hypoexp_cdf(grid, a, b)
    return _order_stat_mean(F, grid, params.n, params.n - s)


def expected_total_runtime(params: RuntimeParams, d: int, s: int, m: int,
                           npts: int = 200_000) -> float:
    """E[T_tot] (paper Sec. VI-A)."""
    if s != d - m:
        # the paper always sets s = d - m on the optimal frontier, but the
        # model is well-defined for any s <= d - m.
        if s > d - m:
            raise ValueError("infeasible triple: need s <= d - m")
    return d * params.t1 + params.t2 / m + expected_order_stat(params, d, s, m, npts)


def _shifted_exp_cdf(t: np.ndarray, rate: float, shift: float) -> np.ndarray:
    """CDF of ``shift + Exp(rate)``: 0 below the shift, 1-exp(-rate*(t-shift))
    above it — the per-phase distribution of the Sec-VI model *including*
    its deterministic floor (unlike :func:`hypoexp_cdf`, which models only
    the random parts and leaves the shifts to the caller)."""
    t = np.asarray(t, dtype=np.float64)
    return np.where(t >= shift, -np.expm1(-rate * np.maximum(t - shift, 0.0)),
                    0.0)


def _phase_grid(params: RuntimeParams, rate: float, shift: float,
                npts: int) -> np.ndarray:
    return np.linspace(0.0,
                       shift + (math.log(max(params.n, 2)) + 45.0) / rate,
                       npts)


def expected_phase_runtimes(params: RuntimeParams, d: int, s: int, m: int,
                            npts: int = 200_000) -> tuple[float, float]:
    """(E[compute wait], E[communication wait]) of a synchronous step.

    Each phase taken alone: the master's compute wait is the (n-s)-th order
    statistic of ``d*t1 + Exp(lambda1/d)`` across workers, the communication
    wait the same statistic of ``t2/m + Exp(m*lambda2)``.  The pipelined
    step's bench composes these with measured encode/drain wall-clocks to
    form the phase totals behind the gated ``overlap_fraction`` metric.
    """
    out = []
    for rate, shift in ((params.lambda1 / d, d * params.t1),
                        (m * params.lambda2, params.t2 / m)):
        grid = _phase_grid(params, rate, shift, npts)
        F = _shifted_exp_cdf(grid, rate, shift)
        out.append(_order_stat_mean(F, grid, params.n, params.n - s))
    return out[0], out[1]


def expected_total_runtime_overlapped(params: RuntimeParams, d: int, s: int,
                                      m: int, npts: int = 200_000,
                                      eps: float = 0.0) -> float:
    """E[T_tot] of the *pipelined* step: max(compute, comm) + eps.

    In the steady state of the stale-by-one pipelined step
    (``make_coded_train_step(pipelined=True)``) worker ``i``'s step-t
    collective overlaps its step-(t+1) compute, so the worker's cycle time
    is ``max(T_comp_i, T_comm_i)`` instead of the sum; the master still
    waits for the fastest ``n - s``.  With the phases independent the max's
    CDF is the product of the two shifted-exponential CDFs, and the same
    order-statistic survival integral as :func:`expected_total_runtime`
    applies.  ``eps`` is the pipeline's residual serial cost (fill/drain
    amortisation and the stale-by-one bookkeeping) — the planner adds a
    small positive value so pipelining never wins on a pure tie against the
    synchronous step it perturbs.
    """
    if s > d - m:
        raise ValueError("infeasible triple: need s <= d - m")
    a, shift_a = params.lambda1 / d, d * params.t1
    b, shift_b = m * params.lambda2, params.t2 / m
    rate = min(a, b)
    t_hi = max(shift_a, shift_b) + (math.log(max(params.n, 2)) + 45.0) / rate
    grid = np.linspace(0.0, t_hi, npts)
    F = (_shifted_exp_cdf(grid, a, shift_a)
         * _shifted_exp_cdf(grid, b, shift_b))
    return _order_stat_mean(F, grid, params.n, params.n - s) + eps


def runtime_table(params: RuntimeParams, npts: int = 120_000) -> np.ndarray:
    """(n, n) table: entry [m-1, d-1] = E[T_tot] for s = d - m (NaN if m > d).

    Reproduces the paper's Section VI-A table layout (rows m, columns d).
    """
    n = params.n
    out = np.full((n, n), np.nan)
    for d in range(1, n + 1):
        for m in range(1, d + 1):
            out[m - 1, d - 1] = expected_total_runtime(params, d, d - m, m, npts)
    return out


def optimal_triple(params: RuntimeParams, npts: int = 120_000,
                   restrict_m1: bool = False) -> tuple[tuple[int, int, int], float]:
    """argmin over the optimal frontier s = d - m.  ``restrict_m1`` searches
    only m = 1 (the Tandon et al. family) for baseline comparisons."""
    best, best_v = None, math.inf
    for d in range(1, params.n + 1):
        ms = [1] if restrict_m1 else range(1, d + 1)
        for m in ms:
            if m > d:
                continue
            v = expected_total_runtime(params, d, d - m, m, npts)
            if v < best_v:
                best, best_v = (d, d - m, m), v
    assert best is not None
    return best, best_v


# --------------------------------------------------------- closed-form regimes
def compute_dominant_mean(params: RuntimeParams, d: int) -> float:
    """Paper eq. (30): m = 1, ignore communication."""
    n = params.n
    harm = sum(1.0 / (n - i) for i in range(0, n - d + 1))
    return d * params.t1 + (d / params.lambda1) * harm


def proposition1_optimal_d(params: RuntimeParams) -> int:
    """Proposition 1: optimal d is 1 or n by threshold on lambda1*t1."""
    n = params.n
    threshold = sum(1.0 / i for i in range(2, n + 1)) / (n - 1)
    return n if params.lambda1 * params.t1 < threshold else 1


def communication_dominant_mean(params: RuntimeParams, m: int) -> float:
    """d = n, s = n - m, ignore computation."""
    n = params.n
    harm = sum(1.0 / (n - i) for i in range(0, m))
    return params.t2 / m + harm / (m * params.lambda2)


def proposition2_optimal_alpha(lambda2: float, t2: float) -> float:
    """Proposition 2: unique root in (0,1) of a/(1-a) + log(1-a) = lambda2*t2."""
    target = lambda2 * t2
    lo, hi = 1e-12, 1.0 - 1e-12
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        val = mid / (1.0 - mid) + math.log1p(-mid)
        if val < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ------------------------------------------------------------- Monte-Carlo sim
def simulate_runtimes(params: RuntimeParams, d: int, s: int, m: int,
                      iters: int, seed: int = 0) -> np.ndarray:
    """Monte-Carlo draws of T_tot (used by the Fig. 3/4 analogues)."""
    rng = np.random.default_rng(seed)
    n = params.n
    comp = d * (params.t1 + rng.exponential(1.0 / params.lambda1, (iters, n)))
    comm = (params.t2 + rng.exponential(1.0 / params.lambda2, (iters, n))) / m
    tot = comp + comm
    return np.sort(tot, axis=1)[:, n - s - 1]  # (n-s)-th smallest, 0-based
