"""Theorem 1: the fundamental (d, s, m) tradeoff and feasibility checks."""
from __future__ import annotations

import math


def is_achievable(n: int, k: int, d: int, s: int, m: int) -> bool:
    """Paper eq. (4): d/k >= (s+m)/n (with integrality of d implicit)."""
    if not (1 <= d <= k and m >= 1 and s >= 0):
        return False
    return d * n >= k * (s + m)


def min_d(n: int, k: int, s: int, m: int) -> int:
    """Smallest feasible computation load (number of subsets per worker)."""
    return math.ceil(k * (s + m) / n)


def max_s(n: int, k: int, d: int, m: int) -> int:
    """Largest tolerable straggler count at load d and reduction m."""
    return max(-1, math.floor(d * n / k) - m)  # -1 == infeasible even at s=0


def max_m(n: int, k: int, d: int, s: int) -> int:
    """Largest communication reduction at load d and straggler target s."""
    return max(0, math.floor(d * n / k) - s)


def comm_bytes_per_worker(l: int, m: int, dtype_bytes: int = 4) -> int:
    """Per-worker egress in the paper's master-worker model: l/m scalars."""
    return (l // m) * dtype_bytes


def frontier(n: int, k: int | None = None) -> list[tuple[int, int, int]]:
    """All triples on the optimal frontier d = ceil(k(s+m)/n) with k = n (so
    d = s + m), enumerated as (d, s, m)."""
    k = n if k is None else k
    out = []
    for d in range(1, n + 1):
        for m in range(1, d + 1):
            s = max_s(n, k, d, m)
            if s >= 0:
                out.append((d, s, m))
    return out
