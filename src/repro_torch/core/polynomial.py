"""Recursive-polynomial code construction (paper Section III, Algorithm 1).

Builds, for parameters ``(n, d, s, m)`` with ``d = s + m``:

- evaluation points ``theta`` (paper eq. 23),
- polynomials ``p_i(x) = prod_{j=1..n-d} (x - theta_{(i+j) % n})`` (eq. 8),
- the recursive family ``p_i^{(u)}`` (eq. 9) via Algorithm 1, packed into the
  ``(m*n, n-s)`` matrix ``B`` (eq. 13),
- the Vandermonde matrix ``V`` (eq. 22) whose column i is
  ``[1, theta_i, ..., theta_i^{n-s-1}]``.

Everything here is one-time setup executed on host in float64 (the paper's
master also builds B offline; Section III-B notes high precision can be used
because construction is one-time).
"""
from __future__ import annotations

import numpy as np


def default_thetas(n: int) -> np.ndarray:
    """Paper eq. (23): {±(1 + i/2)} for even n, plus 0 for odd n."""
    vals: list[float] = []
    if n % 2 == 1:
        vals.append(0.0)
    for i in range((n - (n % 2)) // 2):
        vals.append(1.0 + i / 2.0)
        vals.append(-(1.0 + i / 2.0))
    out = np.array(sorted(vals), dtype=np.float64)
    assert out.shape == (n,) and len(np.unique(out)) == n
    return out


def base_polynomials(n: int, d: int, thetas: np.ndarray) -> np.ndarray:
    """Coefficients of p_i, i in [n].  Returns (n, n-d+1), ascending powers.

    p_i has roots theta_{(i+j) % n}, j = 1..n-d, and leading coefficient 1.
    """
    coeffs = np.zeros((n, n - d + 1), dtype=np.float64)
    for i in range(n):
        c = np.array([1.0])
        for j in range(1, n - d + 1):
            root = thetas[(i + j) % n]
            # multiply polynomial by (x - root)
            c = np.concatenate([[0.0], c]) - root * np.concatenate([c, [0.0]])
        assert c.shape == (n - d + 1,)
        coeffs[i] = c
    return coeffs


def build_B(n: int, d: int, s: int, m: int, thetas: np.ndarray | None = None) -> np.ndarray:
    """Algorithm 1: the (m*n, n-s) matrix B.

    Row ``i*m + u`` holds the coefficients (ascending powers, padded to n-s)
    of ``p_i^{(u+1)}`` (0-based u).
    """
    if d != s + m:
        raise ValueError(f"polynomial scheme requires d = s + m, got d={d}, s={s}, m={m}")
    if not (1 <= d <= n and m >= 1 and s >= 0):
        raise ValueError(f"invalid (n={n}, d={d}, s={s}, m={m})")
    if thetas is None:
        thetas = default_thetas(n)
    p = base_polynomials(n, d, thetas)  # (n, n-d+1)
    B = np.zeros((m * n, n - s), dtype=np.float64)
    # u = 0 rows: coefficients of p_i in columns 0..n-d
    for i in range(n):
        B[i * m, : n - d + 1] = p[i]
    # recursive rows (Algorithm 1, 0-based)
    for u in range(1, m):
        for i in range(n):
            r, r_prev, r_base = i * m + u, i * m + u - 1, i * m
            # multiply by x: shift coefficients up by one power
            B[r, 1 : n - d + u + 1] = B[r_prev, 0 : n - d + u]
            # cancel the coefficient at power (n-d) using p_i^{(1)}
            factor = B[r, n - d]
            B[r, : n - d + 1] -= factor * B[r_base, : n - d + 1]
    return B


def vandermonde(n: int, s: int, thetas: np.ndarray | None = None) -> np.ndarray:
    """Paper eq. (22): the (n-s, n) matrix V, column i = powers of theta_i."""
    if thetas is None:
        thetas = default_thetas(n)
    powers = np.arange(n - s, dtype=np.float64)[:, None]  # (n-s, 1)
    return thetas[None, :] ** powers  # (n-s, n)


def verify_construction(n: int, d: int, s: int, m: int,
                        thetas: np.ndarray | None = None,
                        atol: float = 1e-8) -> dict:
    """Check the structural identities (10), (11), (12), (15) of Section III-A.

    Returns a dict of maximal violations; raises AssertionError on failure.
    """
    if thetas is None:
        thetas = default_thetas(n)
    B = build_B(n, d, s, m, thetas)
    V = vandermonde(n, s, thetas)
    P = B @ V  # (m*n, n): P[i*m+u, w] = p_i^{(u+1)}(theta_w)

    # (15): last m columns of B stack n identity matrices
    tail = B[:, n - d :].reshape(n, m, m)
    err_identity = float(np.abs(tail - np.eye(m)[None]).max())

    # (11): p_i^{(u)} vanishes at theta_{(i+j)%n}, j = 1..n-d
    err_roots = 0.0
    for i in range(n):
        for j in range(1, n - d + 1):
            w = (i + j) % n
            err_roots = max(err_roots, float(np.abs(P[i * m : (i + 1) * m, w]).max()))

    # leading-coefficient normalization (10) and the zero band (12) are
    # implied by err_identity == 0, but check B's zero band explicitly:
    err_band = 0.0
    for i in range(n):
        for u in range(1, m):
            # coefficients at powers n-d .. n-d+u-2 must vanish (eq. 12)
            seg = B[i * m + u, n - d : n - d + u - 1]
            if seg.size:
                err_band = max(err_band, float(np.abs(seg).max()))

    # tolerances scale with the magnitude of the polynomial evaluations
    # (theta^deg grows quickly with n; this is the paper's Sec. III-C point)
    scale = max(1.0, float(np.abs(P).max()))
    report = {"identity_tail": err_identity, "roots": err_roots / scale,
              "zero_band": err_band / max(1.0, float(np.abs(B).max()))}
    for k, v in report.items():
        assert v < atol, f"construction check {k} failed: {v}"
    return report
