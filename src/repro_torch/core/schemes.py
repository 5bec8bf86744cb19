"""Unified gradient-coding scheme object.

``GradCode`` packages a code construction (polynomial / Gaussian-random) into
the three artifacts the runtime needs:

- ``C``: (n, d, m) per-worker encode coefficients.  Worker ``i`` transmits
  ``f_i[v] = sum_{j<d, u<m} C[i, j, u] * g_{(i+j)%n}[v*m + u]`` — an
  ``l/m``-dimensional vector (paper eq. 17/18 for the polynomial scheme,
  eq. 25 for the random scheme).
- ``decode_weights(responders)``: (n, m) float64 matrix ``W`` with zero rows at
  stragglers such that ``sum_j g_j[v*m + u] = sum_i W[i, u] * f_i[v]`` for any
  responder set of size >= n - s (paper eq. 19-21 / Section IV).
- numpy reference ``encode`` / ``decode`` used as the oracle by every test and
  by the Pallas-kernel ref checks.

The master-side solve is done with SVD-backed lstsq in float64, matching the
paper's remark that master-side reconstruction is off the hot path.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from . import cyclic, polynomial, random_code


@dataclasses.dataclass(frozen=True)
class GradCode:
    """A (n, d, s, m) gradient code.  Requires d = s + m (optimal tradeoff)."""

    n: int
    d: int
    s: int
    m: int
    # "poly" (Section III) | "random" (Theorem 2) | "chebyshev" / "rotation"
    # (well-conditioned orthonormal-row variants — repro.core.stable)
    kind: str = "poly"
    seed: int = 0       # for kind == "random" / "rotation"

    def __post_init__(self):
        if self.d != self.s + self.m:
            raise ValueError(
                f"optimal tradeoff requires d = s + m (paper eq. 5); "
                f"got d={self.d}, s={self.s}, m={self.m}")
        if not (1 <= self.d <= self.n and self.m >= 1 and self.s >= 0):
            raise ValueError(f"invalid parameters {self}")
        if self.kind not in ("poly", "random", "chebyshev", "rotation"):
            raise ValueError(f"unknown scheme kind {self.kind!r}")

    # ---------------------------------------------------------------- build
    @cached_property
    def V(self) -> np.ndarray:
        """(n-s, n) evaluation matrix."""
        if self.kind == "poly":
            return polynomial.vandermonde(self.n, self.s)
        if self.kind in ("chebyshev", "rotation"):
            from . import stable   # lazy: stable imports this module
            if self.kind == "chebyshev":
                return stable.chebyshev_V(self.n, self.s)
            return stable.rotation_V(self.n, self.s, self.seed)
        return random_code.gaussian_V(self.n, self.s, self.seed)

    @cached_property
    def B(self) -> np.ndarray:
        """(m*n, n-s) coding matrix (the Theorem-2 window construction
        works for any V with invertible cyclic-window submatrices — all
        the non-polynomial kinds route through it)."""
        if self.kind == "poly":
            return polynomial.build_B(self.n, self.d, self.s, self.m)
        return random_code.build_B_from_V(self.n, self.d, self.m, self.V)

    @cached_property
    def C(self) -> np.ndarray:
        """(n, d, m) encode coefficients, float64.

        C[i, j, u] = p-block of dataset (i+j)%n, row u, evaluated at worker i
        = (B @ V)[((i+j)%n)*m + u, i].
        """
        P = self.P  # cached (m*n, n)
        C = np.zeros((self.n, self.d, self.m), dtype=np.float64)
        for i in range(self.n):
            for j in range(self.d):
                w = (i + j) % self.n
                C[i, j, :] = P[w * self.m : (w + 1) * self.m, i]
        return C

    @cached_property
    def P(self) -> np.ndarray:
        """(m*n, n) full coefficient matrix ``B @ V`` (column i = worker i)."""
        return self.B @ self.V

    @cached_property
    def assignment(self) -> np.ndarray:
        """(n, n) bool: worker i holds subset j (cyclic window)."""
        return cyclic.assignment_matrix(self.n, self.d)

    def placement(self) -> np.ndarray:
        """(n, d) subset ids per worker (for the data pipeline)."""
        return cyclic.placement_indices(self.n, self.d)

    def slot_mask(self) -> np.ndarray:
        """(n, d) bool validity of each placement slot (all True: the
        uniform scheme has no padded slots — the hetero family does)."""
        return np.ones((self.n, self.d), dtype=bool)

    @property
    def num_subsets(self) -> int:
        """Number of equal-size data subsets (k = n for the paper's scheme)."""
        return self.n

    @property
    def loads(self) -> tuple[int, ...]:
        """Per-worker subset counts — uniform: every worker holds d."""
        return (self.d,) * self.n

    # ---------------------------------------------------------------- decode
    def decode_weights(self, responders: np.ndarray | list[int]) -> np.ndarray:
        """(n, m) float64 W, zero rows at stragglers.

        ``responders``: indices (or bool mask of length n) of workers whose
        results arrived; must number at least n - s.  (The solve itself —
        paper eq. 21 — is shared with the heterogeneous family:
        :func:`repro.core.hetero.exact_decode_weights`.)
        """
        from .hetero import exact_decode_weights
        return exact_decode_weights(self.V, self.n, self.s, self.m,
                                    responders)

    def partial_decode_weights(self, responders) -> tuple[np.ndarray, float]:
        """Least-squares decode weights + error certificate for *any*
        responder set, including fewer than ``n - s`` (partial recovery).

        Returns ``(W, err_factor)``: the L2 decode error is bounded by
        ``err_factor * sqrt(sum_j ||g_j||^2)`` for every gradient
        realisation; the factor is ~0 whenever ``len(responders) >= n - s``.
        A full responder set short-circuits to the exact solve with
        ``err_factor`` exactly 0.0 (no least-squares residual evaluation).
        See :mod:`repro.core.hetero` for the math.
        """
        from .hetero import partial_decode_weights
        responders = np.asarray(list(responders))
        if responders.dtype == bool:
            responders = np.nonzero(responders)[0]
        if len(set(int(i) for i in responders)) == self.n:
            return self.decode_weights(responders), 0.0
        return partial_decode_weights(self.P, self.n, self.m, responders)

    def reconstruction_condition_number(self, responders) -> float:
        """cond(V_F V_F^T) — the quantity bounded by kappa in Theorem 2."""
        responders = np.asarray(responders)
        if responders.dtype == bool:
            responders = np.nonzero(responders)[0]
        V_F = self.V[:, np.sort(responders)]
        return float(np.linalg.cond(V_F @ V_F.T))

    # ------------------------------------------------------- numpy reference
    def encode(self, G: np.ndarray) -> np.ndarray:
        """Reference encoder.  G: (n, l) per-subset gradients -> F: (n, l/m).

        Worker i only reads rows {i, .., i+d-1} (mod n) of G — the coefficient
        tensor C is exactly zero elsewhere by construction.
        """
        n, l = G.shape
        assert n == self.n and l % self.m == 0
        Gr = G.reshape(n, l // self.m, self.m)
        F = np.zeros((n, l // self.m), dtype=G.dtype)
        for i in range(n):
            rows = [(i + j) % n for j in range(self.d)]
            # (d, l/m, m) x (d, m) -> (l/m)
            F[i] = np.einsum("jvu,ju->v", Gr[rows], self.C[i])
        return F

    def decode(self, F: np.ndarray, responders, *,
               partial: bool = False) -> np.ndarray:
        """Reference decoder.  F: (n, l/m) encodings -> (l,) sum gradient.

        Straggler rows of F may contain garbage; W zeroes them out.  With
        ``partial=True`` any responder set is accepted and the best
        least-squares approximation is returned (see
        :meth:`partial_decode_weights` for the error certificate).
        """
        if partial:
            W, _ = self.partial_decode_weights(responders)
        else:
            W = self.decode_weights(responders)  # (n, m)
        decoded = np.einsum("nv,nu->vu", F, W)  # (l/m, m)
        return decoded.reshape(-1)

    # ----------------------------------------------------------------- misc
    @property
    def comm_fraction(self) -> float:
        """Per-worker transmitted fraction of l (the paper's 1/m)."""
        return 1.0 / self.m

    def describe(self) -> str:
        return (f"GradCode(kind={self.kind}, n={self.n}, d={self.d}, "
                f"s={self.s}, m={self.m}) — each worker computes {self.d}/{self.n} "
                f"of the data, sends l/{self.m}, tolerates any {self.s} stragglers")


def make_code(n: int, d: int, s: int, m: int, kind: str | None = None,
              seed: int = 0) -> GradCode:
    """Factory with the paper's stability-driven default: polynomial
    (Vandermonde) codes up to n = 20, Gaussian random codes beyond
    (Sections III-C and IV-A).

    >>> code = make_code(4, 3, 1, 2)
    >>> code.C.shape            # per-worker (d, m) encode coefficient rows
    (4, 3, 2)
    >>> code.comm_fraction      # each worker transmits l/m floats
    0.5
    """
    if kind is None:
        kind = "poly" if n <= 20 else "random"
    return GradCode(n=n, d=d, s=s, m=m, kind=kind, seed=seed)


def uncoded(n: int) -> GradCode:
    """The naive scheme as the degenerate code (d=1, s=0, m=1)."""
    return GradCode(n=n, d=1, s=0, m=1, kind="poly")
