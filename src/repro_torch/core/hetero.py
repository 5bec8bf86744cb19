"""Heterogeneous-load and partial-recovery gradient coding.

Two beyond-paper scheme families built on the same ``B @ V`` algebra as
:class:`repro.core.schemes.GradCode`:

**Heterogeneous clusters** (Jahani-Nezhad & Maddah-Ali, "Optimal
Communication-Computation Trade-Off in Heterogeneous Gradient Coding").
The paper's scheme gives every worker the same computation load ``d``; on a
cluster with per-worker speeds ``mu_i`` the uniform scheme either waits for
the slow workers or burns its straggler budget ``s`` dropping them
deterministically.  :func:`plan_hetero` splits the data into ``k`` equal
subsets (``k`` need not equal ``n``) and assigns worker ``i`` a load of
``d_i ~ k * (s+m) * mu_i / sum(mu)`` subsets, so every worker finishes in
the same expected time and ``s`` stays available for genuine noise.  The
resulting :class:`HeteroCode` keeps the paper's decode interface: each
worker still transmits one ``l/m``-sized encoding, and the master decodes
from any ``n - s`` responders with the same ``(n, m)`` weight matrix solve.

*Construction.*  Exactness of the decode requires ``P @ W = 1_k (x) I_m``
where ``P = B @ V`` is the ``(m*k, n)`` coefficient matrix (column ``i`` is
worker ``i``'s encode coefficients over all subset blocks).  Worker ``i``
may only read subsets it holds, so block ``j`` of column ``i`` must vanish
whenever ``i`` does not hold subset ``j``.  For each subset ``j`` with
holder set ``H_j`` we build the ``(m, n-s)`` block ``B_j`` inside the left
null space of ``V[:, i not in H_j]`` (dimension ``|H_j| - s``) and normalise
it so ``B_j @ E = I_m`` (``E`` the last ``m`` columns of ``I_{n-s}``).  That
is solvable exactly when ``|H_j| >= s + m`` — the heterogeneous
generalisation of the paper's optimal ``d = s + m``; every subset is
replicated ``s + m`` times while *workers* carry unequal numbers of
subsets.  Decoding is then identical to the uniform scheme: ``W_F`` solves
``V_F @ W_F = E``, independent of the loads.

**Partial recovery** (Sarmasarkar, Pal & Vaze, "On Gradient Coding with
Partial Recovery").  When fewer than ``n - s`` workers respond the exact
solve is infeasible; instead of aborting the step,
:func:`partial_decode_weights` returns the least-squares weights minimising
the decode-error operator ``M = P_F @ W_F - 1_k (x) I_m`` in Frobenius norm,
plus an **error certificate**: the spectral norm ``sigma_max(M)`` satisfies

    || g_hat - sum_j g_j ||_2  <=  sigma_max(M) * sqrt(sum_j ||g_j||_2^2)

for *every* gradient realisation (see :func:`certificate_bound`), so the
training loop can decide whether a degraded step is usable.  With
``|F| >= n - s`` responders the residual is ~0 and partial mode reduces to
the exact decode.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Sequence

import numpy as np

from . import polynomial, random_code


# ----------------------------------------------------------------- decode math
def exact_decode_weights(V: np.ndarray, n: int, s: int, m: int,
                         responders: np.ndarray | Sequence[int]) -> np.ndarray:
    """The load-independent exact decode solve shared by every code family.

    Solves ``V_F @ W_F = E`` (E = the last m columns of ``I_{n-s}``) for a
    responder set of size >= n - s and scatters the solution into an (n, m)
    float64 matrix with zero rows at stragglers — the uniform scheme's
    paper eq. 21 solve, reused verbatim by :class:`HeteroCode` (whose B
    construction makes decoding independent of the per-worker loads).
    """
    responders = np.asarray(responders)
    if responders.dtype == bool:
        responders = np.nonzero(responders)[0]
    F = np.sort(responders)
    if len(F) < n - s:
        raise ValueError(
            f"need >= n-s = {n - s} responders, got {len(F)}; pass "
            f"partial=True to decode a least-squares approximation")
    V_F = V[:, F]
    E = np.eye(n - s)[:, n - s - m:]
    if len(F) == n - s:
        # square system: direct solve (paper eq. 21, A_F^{-1})
        y = np.linalg.solve(V_F, E)
    else:
        # min-norm solution of V_F @ y = E (exact: V_F has full row rank)
        y, *_ = np.linalg.lstsq(V_F, E, rcond=None)
    W = np.zeros((n, m), dtype=np.float64)
    W[F] = y
    return W


# --------------------------------------------------------------- partial math
def partial_decode_weights(P: np.ndarray, n: int, m: int,
                           responders: np.ndarray | Sequence[int],
                           ) -> tuple[np.ndarray, float]:
    """Least-squares decode weights + error certificate for any responder set.

    P: (m*k, n) coefficient matrix (``code.P``); ``responders`` may be fewer
    than the exact-recovery threshold ``n - s``.  Returns ``(W, err_factor)``
    where ``W`` is (n, m) float64 with zero rows at non-responders and
    ``err_factor = sigma_max(P @ W - 1_k (x) I_m)`` — the certificate factor
    such that the L2 decode error is bounded by
    ``err_factor * sqrt(sum_j ||g_j||^2)`` for every gradient realisation.
    On responder sets of size >= n - s the residual (and the factor) is ~0.
    """
    responders = np.asarray(responders)
    if responders.dtype == bool:
        responders = np.nonzero(responders)[0]
    F = np.sort(responders).astype(int)
    k = P.shape[0] // m
    target = np.tile(np.eye(m), (k, 1))              # 1_k (x) I_m, (m*k, m)
    W = np.zeros((n, m), dtype=np.float64)
    if len(F):
        Y, *_ = np.linalg.lstsq(P[:, F], target, rcond=None)
        W[F] = Y
    err_factor = float(np.linalg.norm(P @ W - target, 2))
    return W, max(err_factor, 0.0)


def certificate_bound(P: np.ndarray, W: np.ndarray, G: np.ndarray,
                      m: int) -> float:
    """Evaluate the certificate ``sigma_max(PW - 1 (x) I) * ||G||_F`` for a
    concrete per-subset gradient matrix ``G`` of shape (k, l).

    This is the quantity the hypothesis property test checks against the
    true L2 gap of :meth:`HeteroCode.decode` / ``GradCode.decode`` under
    random erasure patterns.
    """
    k = P.shape[0] // m
    target = np.tile(np.eye(m), (k, 1))
    sigma = float(np.linalg.norm(P @ W - target, 2))
    return sigma * float(np.linalg.norm(G))


# ------------------------------------------------------------------- planning
@dataclasses.dataclass(frozen=True)
class HeteroPlan:
    """Per-worker load assignment derived from a cluster speed vector.

    speeds: relative per-worker speeds (1.0 = nominal); loads: number of
    data subsets assigned to each worker (sums to ``k * (s + m)``); ``k``:
    number of equal-size data subsets (decoupled from ``n``).
    """
    n: int
    s: int
    m: int
    k: int
    speeds: tuple[float, ...]
    loads: tuple[int, ...]

    @property
    def replication(self) -> int:
        """Copies of every subset across workers (= s + m, the optimal d)."""
        return self.s + self.m

    def describe(self) -> str:
        """One-line human-readable summary of the plan."""
        return (f"HeteroPlan(n={self.n}, s={self.s}, m={self.m}, k={self.k}, "
                f"loads={self.loads}) — worker i computes loads[i]/{self.k} "
                f"of the data, sends l/{self.m}, tolerates any {self.s} "
                f"stragglers")


def plan_loads(speeds: Sequence[float], k: int, r: int,
               departed: Sequence[int] = ()) -> tuple[int, ...]:
    """Integer per-worker loads proportional to ``speeds``.

    Largest-remainder rounding of ``k * r * speeds / sum(speeds)`` with the
    per-worker cap ``load <= k`` enforced by redistributing the excess to the
    fastest uncapped workers.  The result always sums to ``k * r``.

    ``departed`` pins the named workers to exactly zero load (the elastic
    degradation rung: a departed worker becomes a pure straggler holding no
    data); the full ``k * r`` replication is carried by the remaining
    workers, so feasibility requires ``r`` alive workers.
    """
    mu = np.asarray(speeds, dtype=np.float64)
    n = len(mu)
    departed = sorted({int(i) for i in departed})
    if any(i < 0 or i >= n for i in departed):
        raise ValueError(f"departed indices {departed} out of range 0..{n-1}")
    if departed:
        alive = [i for i in range(n) if i not in departed]
        sub = plan_loads(mu[alive], k, r)
        out = np.zeros(n, dtype=int)
        out[alive] = sub
        return tuple(int(x) for x in out)
    if np.any(mu <= 0):
        raise ValueError(f"speeds must be positive, got {list(speeds)}")
    if not (0 < r <= n):
        raise ValueError(f"replication {r} must be in 1..n={n}")
    total = k * r
    if total > n * k:
        raise ValueError(f"k*r = {total} exceeds capacity n*k = {n * k}")
    raw = total * mu / mu.sum()
    loads = np.floor(raw).astype(int)
    # largest-remainder distribution of the rounding shortfall
    order = np.argsort(-(raw - loads))
    for i in range(total - int(loads.sum())):
        loads[order[i % n]] += 1
    # cap at k (a worker cannot hold more subsets than exist), pushing the
    # excess onto the fastest workers with remaining headroom
    while loads.max() > k:
        i = int(np.argmax(loads))
        excess, loads[i] = loads[i] - k, k
        room = np.nonzero(loads < k)[0]
        for j in sorted(room, key=lambda x: -mu[x]):
            take = min(excess, k - loads[j])
            loads[j] += take
            excess -= take
            if excess == 0:
                break
    assert loads.sum() == total and loads.max() <= k
    return tuple(int(x) for x in loads)


def balanced_assignment(loads: Sequence[int], k: int, r: int) -> np.ndarray:
    """(n, k) bool assignment: subset ``j`` gets exactly ``r`` holders and
    worker ``i`` gets exactly ``loads[i]`` subsets.

    Greedy: subsets are filled in turn, each taking the ``r`` workers with
    the largest remaining quota (ties broken by worker index) — feasible
    whenever ``sum(loads) == k * r`` and ``max(loads) <= k``.
    """
    loads = np.asarray(loads, dtype=int)
    n = len(loads)
    if loads.sum() != k * r:
        raise ValueError(f"sum(loads)={loads.sum()} != k*r={k * r}")
    if loads.max() > k or loads.min() < 0:
        raise ValueError(f"loads must lie in [0, k={k}], got {list(loads)}")
    if r > n:
        raise ValueError(f"replication {r} exceeds n={n}")
    remaining = loads.copy()
    out = np.zeros((n, k), dtype=bool)
    for j in range(k):
        # r workers with the largest remaining quota; stable for ties
        pick = np.argsort(-remaining, kind="stable")[:r]
        if remaining[pick[-1]] <= 0:
            raise ValueError(f"infeasible assignment: subset {j} cannot "
                             f"find {r} holders (loads={list(loads)})")
        out[pick, j] = True
        remaining[pick] -= 1
    assert (out.sum(axis=0) == r).all() and (out.sum(axis=1) == loads).all()
    return out


def plan_hetero(speeds: Sequence[float], s: int, m: int,
                k: int | None = None,
                departed: Sequence[int] = ()) -> HeteroPlan:
    """Build a :class:`HeteroPlan` from a per-worker speed vector.

    ``k`` defaults to ``2 * n`` — twice as many subsets as workers gives the
    load assignment half-worker granularity without exploding the batch
    divisibility requirement (the global batch must be divisible by ``k``).

    ``departed`` assigns the named workers zero load at unchanged ``n``
    (elastic degradation rung 2: the departed worker stays in the code's
    index space as a pure straggler, so the mesh, wire format and decode
    shapes are untouched).  Exact decode then additionally requires the
    straggler budget to cover the departures (``s >= len(departed)``),
    since a departed worker never responds.
    """
    n = len(speeds)
    k = 2 * n if k is None else k
    r = s + m
    if departed and s < len(set(int(i) for i in departed)):
        raise ValueError(
            f"straggler budget s={s} cannot cover {len(set(departed))} "
            f"departed (never-responding) workers; raise s or resize")
    loads = plan_loads(speeds, k, r, departed=departed)
    return HeteroPlan(n=n, s=s, m=m, k=k,
                      speeds=tuple(float(x) for x in speeds), loads=loads)


# ------------------------------------------------------------------ the code
@dataclasses.dataclass(frozen=True)
class HeteroCode:
    """A heterogeneous-load gradient code with the ``GradCode`` runtime surface.

    Duck-compatible with :class:`repro.core.schemes.GradCode` everywhere the
    runtime touches a code: ``n``/``s``/``m``/``d`` (= max load, the batch
    slot count), ``C`` (n, d, m) encode coefficients (zero rows at padded
    slots), ``placement()``/``slot_mask()`` for the data pipeline and the
    rho weights, ``decode_weights`` / ``partial_decode_weights`` for the
    per-pattern host solve, and the numpy ``encode``/``decode`` oracle pair.
    """

    plan: HeteroPlan
    kind: str = "random"  # "random" (Gaussian V) | "poly" (Vandermonde V)
    seed: int = 0

    def __post_init__(self):
        """Validate the plan and eagerly run the assignment feasibility check."""
        p = self.plan
        if p.s + p.m > p.n:
            raise ValueError(f"replication s+m = {p.s + p.m} exceeds n={p.n}")
        if self.kind not in ("poly", "random"):
            raise ValueError(f"unknown scheme kind {self.kind!r}")
        # triggers the feasibility checks eagerly
        _ = self.assignment

    # ---- GradCode-compatible scalar surface
    @property
    def n(self) -> int:
        """Number of workers."""
        return self.plan.n

    @property
    def s(self) -> int:
        """Design straggler tolerance."""
        return self.plan.s

    @property
    def m(self) -> int:
        """Communication compression: each worker transmits l/m floats."""
        return self.plan.m

    @property
    def d(self) -> int:
        """Max per-worker load — the (padded) subset-slot count of the
        batch layout; slower workers carry zero-coefficient padded slots."""
        return max(self.plan.loads) if self.plan.loads else 0

    @property
    def num_subsets(self) -> int:
        """Number of equal-size data subsets k (decoupled from n)."""
        return self.plan.k

    @property
    def loads(self) -> tuple[int, ...]:
        """Per-worker subset counts (the plan's load vector)."""
        return self.plan.loads

    @property
    def comm_fraction(self) -> float:
        """Per-worker transmitted fraction of l (the paper's 1/m)."""
        return 1.0 / self.m

    # ---------------------------------------------------------------- build
    @cached_property
    def assignment(self) -> np.ndarray:
        """(n, k) bool: worker i holds subset j (balanced greedy fill)."""
        return balanced_assignment(self.plan.loads, self.plan.k,
                                   self.plan.replication)

    def placement(self) -> np.ndarray:
        """(n, d) subset ids per worker, d = max load.

        Padded slots (worker load < d) repeat the worker's first subset (or
        subset 0 for a zero-load worker); their encode coefficients and rho
        weights are exactly zero, so the duplicated data is never used.
        """
        d = self.d
        out = np.zeros((self.n, d), dtype=int)
        for i in range(self.n):
            subs = np.nonzero(self.assignment[i])[0]
            pad = subs[0] if len(subs) else 0
            out[i] = np.concatenate([subs, np.full(d - len(subs), pad)])
        return out

    def slot_mask(self) -> np.ndarray:
        """(n, d) bool: True at real subset slots, False at padding."""
        d = self.d
        return np.arange(d)[None, :] < np.asarray(self.plan.loads)[:, None]

    @cached_property
    def V(self) -> np.ndarray:
        """(n-s, n) evaluation matrix (Gaussian by default; Vandermonde for
        kind='poly', stable up to n ~ 20 as in the uniform scheme)."""
        if self.kind == "poly":
            return polynomial.vandermonde(self.n, self.s)
        return random_code.gaussian_V(self.n, self.s, self.seed)

    @cached_property
    def B(self) -> np.ndarray:
        """(m*k, n-s) coding matrix: block j lives in the left null space of
        the non-holders' V columns and satisfies ``B_j @ E = I_m``."""
        n, s, m, k = self.n, self.s, self.m, self.plan.k
        E = np.eye(n - s)[:, n - s - m:]                 # (n-s, m)
        B = np.zeros((m * k, n - s), dtype=np.float64)
        for j in range(k):
            non_holders = np.nonzero(~self.assignment[:, j])[0]
            V_bar = self.V[:, non_holders]               # (n-s, n-h_j)
            # left null space of V_bar: singular vectors with ~zero singular
            # values of V_bar^T; dimension h_j - s >= m by construction
            u, sv, _ = np.linalg.svd(V_bar, full_matrices=True)
            rank = int((sv > 1e-10 * (sv[0] if len(sv) else 1.0)).sum())
            Z = u[:, rank:]                              # (n-s, h_j - s)
            if Z.shape[1] < m:
                raise ValueError(
                    f"subset {j}: holder count {int(self.assignment[:, j].sum())}"
                    f" < s + m = {s + m}; cannot build an exact-decode block")
            ZE = Z.T @ E                                 # (h_j - s, m)
            Y = np.linalg.pinv(ZE)                       # (m, h_j - s)
            B[j * m:(j + 1) * m] = Y @ Z.T
        return B

    @cached_property
    def P(self) -> np.ndarray:
        """(m*k, n) full coefficient matrix ``B @ V`` (column i = worker i)."""
        return self.B @ self.V

    @cached_property
    def C(self) -> np.ndarray:
        """(n, d, m) per-worker encode coefficients, zero at padded slots."""
        placement = self.placement()
        mask = self.slot_mask()
        C = np.zeros((self.n, self.d, self.m), dtype=np.float64)
        for i in range(self.n):
            for slot in range(self.d):
                if mask[i, slot]:
                    j = placement[i, slot]
                    C[i, slot, :] = self.P[j * self.m:(j + 1) * self.m, i]
        return C

    # ---------------------------------------------------------------- decode
    def decode_weights(self, responders: np.ndarray | Sequence[int]
                       ) -> np.ndarray:
        """(n, m) float64 W with zero rows at stragglers; exact for any
        responder set of size >= n - s (identical solve to the uniform
        scheme: ``V_F @ W_F = E``, load-independent by construction)."""
        return exact_decode_weights(self.V, self.n, self.s, self.m,
                                    responders)

    def partial_decode_weights(self, responders) -> tuple[np.ndarray, float]:
        """Least-squares weights + error certificate for *any* responder set
        (including fewer than n - s).  A full responder set short-circuits
        to the exact solve with ``err_factor`` exactly 0.0.  See
        :func:`partial_decode_weights`."""
        responders = np.asarray(list(responders))
        if responders.dtype == bool:
            responders = np.nonzero(responders)[0]
        if len(set(int(i) for i in responders)) == self.n:
            return self.decode_weights(responders), 0.0
        return partial_decode_weights(self.P, self.n, self.m, responders)

    # ------------------------------------------------------- numpy reference
    def encode(self, G: np.ndarray) -> np.ndarray:
        """Reference encoder.  G: (k, l) per-subset gradients -> F: (n, l/m).

        Worker i reads only its assigned subsets (C is zero elsewhere by the
        null-space construction).
        """
        k, l = G.shape
        assert k == self.plan.k and l % self.m == 0
        Gr = G.reshape(k, l // self.m, self.m)
        F = np.zeros((self.n, l // self.m), dtype=G.dtype)
        placement, mask = self.placement(), self.slot_mask()
        for i in range(self.n):
            for slot in range(self.d):
                if mask[i, slot]:
                    j = placement[i, slot]
                    F[i] += np.einsum("vu,u->v", Gr[j], self.C[i, slot])
        return F

    def decode(self, F: np.ndarray, responders, *, partial: bool = False
               ) -> np.ndarray:
        """Reference decoder.  F: (n, l/m) encodings -> (l,) sum gradient.

        With ``partial=True`` any responder set is accepted and the
        least-squares approximation is returned (use
        :meth:`partial_decode_weights` for its error certificate).
        """
        if partial:
            W, _ = self.partial_decode_weights(responders)
        else:
            W = self.decode_weights(responders)
        decoded = np.einsum("nv,nu->vu", F, W)
        return decoded.reshape(-1)

    # ----------------------------------------------------------------- misc
    def describe(self) -> str:
        """One-line human-readable summary of the code."""
        return (f"HeteroCode(kind={self.kind}, n={self.n}, s={self.s}, "
                f"m={self.m}, k={self.plan.k}, loads={self.plan.loads}) — "
                f"worker i computes loads[i]/{self.plan.k} of the data, "
                f"sends l/{self.m}, tolerates any {self.s} stragglers")


def make_hetero_code(speeds: Sequence[float], s: int, m: int, *,
                     k: int | None = None, kind: str | None = None,
                     seed: int = 0,
                     departed: Sequence[int] = ()) -> HeteroCode:
    """Factory: speed vector -> :class:`HeteroCode`.

    Mirrors :func:`repro.core.schemes.make_code`'s stability default:
    Vandermonde ("poly") V up to n = 20 workers, Gaussian beyond.
    ``departed`` workers get zero load at unchanged ``n`` (elastic rung 2,
    see :func:`plan_hetero`).

    >>> code = make_hetero_code([0.5, 1.0, 1.0, 1.5], s=1, m=2)
    >>> code.loads                      # fast workers hold more subsets
    (3, 7, 6, 8)
    >>> int(code.assignment.sum())      # every subset replicated s+m times
    24
    """
    n = len(speeds)
    if kind is None:
        kind = "poly" if n <= 20 else "random"
    return HeteroCode(plan=plan_hetero(speeds, s, m, k=k, departed=departed),
                      kind=kind, seed=seed)
