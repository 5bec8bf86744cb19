"""Numerically-stable random-matrix construction (paper Section IV, Theorem 2).

Given (n, d, m) with design straggler count s = d - m:

- V is an (n-s) x n matrix; the paper recommends i.i.d. Gaussian entries
  (Section IV-A) for numerical stability up to n ~ 30.
- For each i, S_i is the (n-d) x (n-d) submatrix of V's first (n-d) rows at
  cyclically-consecutive columns {i, i+1, ..., i+n-d-1}; R_i the corresponding
  m x (n-d) submatrix of the last m rows.  The dataset-i row block of B is
  [B_i  I_m] with B_i = -R_i S_i^{-1}, which is orthogonal to V's columns
  {i, ..., i+n-d-1} — so dataset D_i is needed only by workers
  {i+n-d, ..., i+n-1} (mod n), a cyclic d-window.

NOTE on assignment convention: the Theorem-2 construction as literally stated
assigns D_i to workers {i-d, ..., i-1} (mod n).  To keep a single cyclic
convention across the code base (worker i holds subsets {i, ..., i+d-1}, as in
Section III), we instead make the block of dataset D_i orthogonal to columns
{i+1, ..., i+n-d} (mod n) — the same index shift the polynomial scheme uses via
its root pattern.  Tests assert the resulting sparsity pattern equals
``cyclic.assignment_matrix``.
"""
from __future__ import annotations

import numpy as np


def gaussian_V(n: int, s: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n - s, n)) / np.sqrt(n - s)


def build_B_from_V(n: int, d: int, m: int, V: np.ndarray) -> np.ndarray:
    """The (m*n, n-s) matrix B with row-block i = [B_i  I_m] in the basis
    implied by condition (24), using our cyclic-window convention."""
    s = d - m
    if s < 0:
        raise ValueError("need d >= m")
    if V.shape != (n - s, n):
        raise ValueError(f"V must be (n-s, n) = {(n - s, n)}, got {V.shape}")
    B = np.zeros((m * n, n - s), dtype=np.float64)
    for i in range(n):
        # dataset D_i must NOT be needed by workers {i+1, ..., i+n-d} (mod n)
        cols = [(i + 1 + t) % n for t in range(n - d)]
        S_i = V[: n - d, cols]            # (n-d, n-d)
        R_i = V[n - d :, cols]            # (m, n-d)
        B_i = -np.linalg.solve(S_i.T, R_i.T).T  # = -R_i @ inv(S_i)
        B[i * m : (i + 1) * m, : n - d] = B_i
        B[i * m : (i + 1) * m, n - d :] = np.eye(m)
    return B


def verify_orthogonality(n: int, d: int, m: int, V: np.ndarray, B: np.ndarray,
                         atol: float = 1e-8) -> float:
    """max |<row block of dataset i, column w of V>| over non-assigned (i, w)."""
    P = B @ V  # (m*n, n)
    err = 0.0
    for i in range(n):
        for t in range(n - d):
            w = (i + 1 + t) % n
            err = max(err, float(np.abs(P[i * m : (i + 1) * m, w]).max()))
    assert err < atol, f"orthogonality violated: {err}"
    return err
