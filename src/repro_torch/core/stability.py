"""Numerical-stability machinery (paper Sections III-C, IV and Theorem 2).

- empirical gamma(n, n1, n2, kappa): smallest n3 >= n1 such that a candidate V
  has cond(V_F V_F^T) <= kappa for all (sampled) |F| = n3 — the function whose
  existence drives Theorem 2's achievable region  s_kappa <= n - gamma(...).
- the analytic upper bound of eq. (7) via f_{n,n1}(x).
- end-to-end worst-case relative decode error measurement, reproducing the
  paper's reported boundaries (Vandermonde fine to n<=20, ~80% error by n=23;
  Gaussian fine to n<=30).
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from .schemes import GradCode


def entropy(q: float) -> float:
    """Binary (natural-log) entropy H(q), extended by 0 at the endpoints —
    the combinatorial term inside the paper's f_{n,n1} bound."""
    if q <= 0.0 or q >= 1.0:
        return 0.0
    return -q * math.log(q) - (1 - q) * math.log(1 - q)


def f_n_n1(n: int, n1: int, x: float) -> float:
    """Paper's f_{n,n1}(x) = sqrt(n1/x) + sqrt(2n H(x/n) / x)."""
    return math.sqrt(n1 / x) + math.sqrt(2 * n * entropy(x / n) / x)


def gamma_upper_bound(n: int, n1: int, kappa: float) -> int | None:
    """Eq. (7): gamma <= f^{-1}((sqrt(k)-1)/(sqrt(k)+1)) when n1/n > 1/2 and
    kappa above the bulk-conditioning threshold.  Returns None when the
    hypotheses fail (f is only guaranteed monotone for n1/n > 1/2)."""
    if n1 / n <= 0.5:
        return None
    thresh = ((1 + math.sqrt(n1 / n)) / (1 - math.sqrt(n1 / n))) ** 2
    if kappa <= thresh:
        return None
    target = (math.sqrt(kappa) - 1) / (math.sqrt(kappa) + 1)
    # f is strictly decreasing on [n1, n); find smallest integer x with
    # f <= target.  x = n is excluded: entropy(1.0) clamps to 0 there, so
    # f(n) = sqrt(n1/n) < target holds *identically* whenever kappa clears
    # the threshold above — scanning it made the inversion vacuously
    # "succeed" at x = n even when eq. (7) genuinely has no solution.
    for x in range(n1, n):
        if f_n_n1(n, n1, x) <= target:
            return x
    return None


def _subsets(n: int, r: int, max_count: int, rng: np.random.Generator):
    total = math.comb(n, r)
    if total <= max_count:
        yield from itertools.combinations(range(n), r)
    else:
        for _ in range(max_count):
            yield tuple(rng.choice(n, size=r, replace=False))


def max_condition_number(V: np.ndarray, n3: int, max_subsets: int = 512,
                         seed: int = 0) -> float:
    """max over (sampled) |F| = n3 of cond(V_F V_F^T)."""
    n = V.shape[1]
    rng = np.random.default_rng(seed)
    worst = 0.0
    for F in _subsets(n, n3, max_subsets, rng):
        VF = V[:, list(F)]
        worst = max(worst, float(np.linalg.cond(VF @ VF.T)))
    return worst


def empirical_gamma(V: np.ndarray, n2: int, kappa: float,
                    max_subsets: int = 512, seed: int = 0) -> int | None:
    """Smallest n3 >= n1 (= rows of V) with max cond <= kappa; None if even
    n3 = n fails.  (Property 2 — invertibility of circulant-consecutive
    n2 x n2 submatrices — holds a.s. for Gaussian V; verified separately.)"""
    n1, n = V.shape
    for n3 in range(n1, n + 1):
        if max_condition_number(V, n3, max_subsets, seed) <= kappa:
            return n3
    return None


def circulant_submatrices_invertible(V: np.ndarray, n2: int,
                                     rcond: float = 1e-12) -> bool:
    """Property 2 of the gamma definition: every n2 x n2 circulant-consecutive
    column submatrix of V's first n2 rows is invertible."""
    n = V.shape[1]
    top = V[:n2]
    for i in range(n):
        cols = [(i + t) % n for t in range(n2)]
        sub = top[:, cols]
        if np.linalg.matrix_rank(sub, tol=rcond * np.abs(sub).max()) < n2:
            return False
    return True


def sample_straggler_sets(n: int, size, trials: int, seed: int = 0, *,
                          dedupe: bool = True):
    """Seeded random straggler index tuples — the shared trial driver for
    the stability sweep, the straggler-bench decode sweeps and the approx
    certificate calibration (they previously each carried an ad-hoc loop).

    ``size`` is either a fixed set size or an inclusive ``(lo, hi)`` range
    drawn uniformly per trial.  Yields sorted tuples; with ``dedupe=True``
    (the default) repeated draws are skipped, so fewer than ``trials``
    tuples may be produced.
    """
    if n < 1:
        raise ValueError(f"need n >= 1 workers, got {n}")
    rng = np.random.default_rng(seed)
    seen: set[tuple[int, ...]] = set()
    for _ in range(trials):
        if isinstance(size, tuple):
            lo, hi = size
            sz = int(rng.integers(lo, hi + 1))
        else:
            sz = int(size)
        if not 0 <= sz <= n:
            raise ValueError(f"straggler set size {sz} outside 0..{n}")
        st = (tuple(sorted(int(x) for x in
                           rng.choice(n, size=sz, replace=False)))
              if sz else ())
        if dedupe:
            if st in seen:
                continue
            seen.add(st)
        yield st


def worst_decode_relative_error(code: GradCode, l: int = 64, trials: int = 32,
                                seed: int = 0, dtype=np.float64) -> float:
    """End-to-end worst relative l_inf decode error over sampled straggler sets
    (the paper's Section III-C experiment)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((code.n, l)).astype(dtype)
    F = code.encode(G)
    truth = G.sum(axis=0)
    scale = np.abs(truth).max()
    worst = 0.0
    for st in sample_straggler_sets(code.n, code.s, trials, seed=seed + 1):
        resp = np.setdiff1d(np.arange(code.n), st)
        try:
            got = code.decode(F, resp)
        except np.linalg.LinAlgError:
            return float("inf")  # the paper's "algorithm crashes" regime
        err = float(np.abs(got - truth).max() / scale)
        if not math.isfinite(err):
            return float("inf")
        worst = max(worst, err)
    return worst
