"""Cyclic index arithmetic and data-subset assignment (paper Section III).

The paper uses 1-based indices with the binary ops ⊕/⊖ over [n]. We use
0-based indices throughout the code base; ``a ⊕ b`` becomes ``(a + b) % n``.

Worker ``i`` is assigned data subsets ``D_i, D_{i+1}, ..., D_{i+d-1}`` (mod n),
equivalently subset ``D_j`` is held by workers ``W_{j-d+1}, ..., W_j`` (mod n).
"""
from __future__ import annotations

import numpy as np


def worker_subsets(i: int, n: int, d: int) -> list[int]:
    """Data subsets assigned to worker ``i`` (0-based, cyclic window of size d)."""
    return [(i + j) % n for j in range(d)]


def subset_workers(j: int, n: int, d: int) -> list[int]:
    """Workers that hold data subset ``j``."""
    return [(j - u) % n for u in range(d)]


def assignment_matrix(n: int, d: int) -> np.ndarray:
    """(n, n) boolean matrix: entry [i, j] True iff worker i holds subset j."""
    a = np.zeros((n, n), dtype=bool)
    for i in range(n):
        a[i, worker_subsets(i, n, d)] = True
    return a


def placement_indices(n: int, d: int) -> np.ndarray:
    """(n, d) int array: row i lists the subset ids assigned to worker i.

    This is what the data pipeline uses to build the redundant per-worker
    batch tensor of shape (n, d, batch_per_subset, ...).
    """
    return np.stack([np.array(worker_subsets(i, n, d)) for i in range(n)])
