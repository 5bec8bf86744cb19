"""Well-conditioned code constructions that scale to hundreds of workers.

The paper's recursive polynomial construction (Section III-C) decodes through
a Vandermonde system whose conditioning explodes by n ~ 23, and the Gaussian
random alternative (Theorem 2) survives only to n ~ 30 — the near-square
random ``V_F`` behaves like a critical Wishart matrix whose smallest
eigenvalue collapses as n grows.  This module closes that gap with three
families, all duck-compatible with :class:`repro.core.schemes.GradCode` (so
they ride ``SchemeSpec``, the packed wire, and ``make_coded_train_step``
unchanged):

- **chebyshev** — ``V`` is the first ``n - s`` rows of the orthonormal
  DCT-II basis, i.e. the normalised Chebyshev polynomials ``T_r`` evaluated
  at the Chebyshev nodes ``cos(pi (i + 1/2) / n)``.  Discrete Chebyshev
  orthogonality makes the rows of ``V`` exactly orthonormal, so
  ``cond(V_F V_F^T)`` is bounded by the certificate below instead of growing
  exponentially like the paper's equispaced-theta Vandermonde.  The encode
  matrix ``B`` still inverts structured windows, so this family is the
  mid-tier choice: rock-solid at small ``s`` far past n = 23, encode-limited
  at large ``s``.
- **rotation** — ``V`` is the first ``n - s`` rows of a seeded Haar-random
  rotation (orthogonal) matrix.  Rows are exactly orthonormal *and* the
  cyclic encode windows behave like well-conditioned Gaussian blocks, so
  worst-case relative decode error stays near machine precision to n = 64
  and beyond (measured ~1e-12 at n = 64 with s = 19).
- **block** (:class:`BlockCompositeCode`) — a 2D composition tiling a small
  well-conditioned base ``(n0, d, s, m)`` code over ``n / n0`` independent
  tiles of an ``(r x c)`` worker grid.  Decode factors per tile, so no solve
  ever exceeds ``n0`` — even the classic polynomial construction scales to
  hundreds of workers as long as each tile stays inside its stable range.

**Certified conditioning.**  For a ``V`` with orthonormal rows obtained by
deleting ``s`` rows of an orthogonal matrix ``U``,

    ``V_F V_F^T = I - V_Fc V_Fc^T``  and  ``G_Fc = I_s - W_S^T W_S``,

where ``W_S`` is the tiny ``s x |Fc|`` submatrix of the *deleted* rows at the
straggler columns.  Hence ``cond(V_F V_F^T) = 1 / sigma_min(W_S)^2``, and
removing columns from ``W_S`` can only raise ``sigma_min`` — the worst case
is always a full-budget straggler set.  :func:`certified_max_cond` therefore
returns the *exact* supremum over every straggler pattern by enumerating
``C(n, s)`` cheap ``s x s`` SVDs whenever that count fits the budget, falls
back to a closed-form Gershgorin bound, and returns ``inf`` (never a guess)
when nothing certifies.  The planner's ``rank_plans(max_cond=...)`` admission
gate consumes exactly this number.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from functools import cached_property, lru_cache

import numpy as np

from . import polynomial, random_code
from .schemes import GradCode, make_code

#: The stable family names the planner / trainer recognise, in search order.
STABLE_FAMILIES = ("chebyshev", "rotation", "block")

#: Default enumeration budget for the exact conditioning certificate: the
#: certificate is exhaustive whenever ``C(n, s) <= CERT_BUDGET`` (covers
#: s <= 3 at n = 64), and honestly ``inf`` past it unless the closed-form
#: fallback applies.
CERT_BUDGET = 50_000

#: float64 unit roundoff — the scale of every certified forward-error bound.
EPS = float(np.finfo(np.float64).eps)


# ------------------------------------------------------- orthonormal bases
def chebyshev_nodes(n: int) -> np.ndarray:
    """The n Chebyshev points of the first kind, ``cos(pi (i + 1/2) / n)``."""
    return np.cos(np.pi * (np.arange(n) + 0.5) / n)


def chebyshev_basis(n: int) -> np.ndarray:
    """(n, n) orthonormal matrix of Chebyshev polynomials at Chebyshev nodes.

    Row ``r`` is ``c_r * T_r(x_i)`` with ``c_0 = sqrt(1/n)`` and
    ``c_r = sqrt(2/n)`` otherwise (the orthonormal DCT-II); discrete
    Chebyshev orthogonality makes ``U U^T = I`` exactly.
    """
    i = np.arange(n)
    U = np.cos(np.pi * (i[None, :] + 0.5) * np.arange(n)[:, None] / n)
    U[0] *= math.sqrt(1.0 / n)
    U[1:] *= math.sqrt(2.0 / n)
    return U


def rotation_basis(n: int, seed: int = 0) -> np.ndarray:
    """(n, n) seeded Haar-random rotation matrix (orthonormal rows).

    QR of a seeded standard-normal matrix with the R-diagonal sign fix, so
    the sample is Haar-distributed *and* byte-identical across processes for
    equal ``(n, seed)``.
    """
    rng = np.random.default_rng(seed)
    Q, R = np.linalg.qr(rng.standard_normal((n, n)))
    Q = Q * np.sign(np.diag(R))[None, :]
    return np.ascontiguousarray(Q.T)


def chebyshev_V(n: int, s: int) -> np.ndarray:
    """(n-s, n) evaluation matrix: orthonormal Chebyshev rows 0 .. n-s-1."""
    _check_ns(n, s)
    return chebyshev_basis(n)[: n - s]


def rotation_V(n: int, s: int, seed: int = 0) -> np.ndarray:
    """(n-s, n) evaluation matrix: first n-s rows of a Haar rotation."""
    _check_ns(n, s)
    return rotation_basis(n, seed)[: n - s]


def dropped_rows(family: str, n: int, s: int, seed: int = 0) -> np.ndarray:
    """(s, n) deleted rows of the family's orthogonal basis — the only
    input the exact conditioning certificate needs."""
    _check_ns(n, s)
    if family == "chebyshev":
        return chebyshev_basis(n)[n - s:]
    if family == "rotation":
        return rotation_basis(n, seed)[n - s:]
    raise ValueError(
        f"no orthonormal-row basis for family {family!r}; expected "
        f"'chebyshev' or 'rotation'")


def _check_ns(n: int, s: int) -> None:
    if not (n >= 1 and 0 <= s < n):
        raise ValueError(f"need n >= 1 and 0 <= s < n, got n={n}, s={s}")


# ------------------------------------------------------------- certificates
def certified_max_cond(dropped: np.ndarray,
                       budget: int = CERT_BUDGET) -> float:
    """Certified sup over all straggler sets of ``cond(V_F V_F^T)``.

    ``dropped`` is the ``(s, n)`` block of rows deleted from an orthogonal
    basis to form ``V``.  Because ``cond(V_F V_F^T) = 1 / sigma_min(W_S)^2``
    with ``W_S`` the dropped-row submatrix at the straggler columns, and
    ``sigma_min`` only shrinks as columns are added, the exact supremum is
    attained on full ``s``-column sets: when ``C(n, s) <= budget`` every one
    is enumerated (an exact certificate, not a sample).  Past the budget a
    closed-form Gershgorin bound on the straggler Gram is tried; if it is
    vacuous the function returns ``inf`` — the admission gate then honestly
    rejects the construction rather than trusting an estimate.
    """
    s, n = dropped.shape
    if s == 0:
        return 1.0
    if math.comb(n, s) <= budget:
        idx = np.fromiter(itertools.chain.from_iterable(
            itertools.combinations(range(n), s)), dtype=int).reshape(-1, s)
        W = np.moveaxis(dropped[:, idx], 1, 0)      # (C(n,s), s, s)
        smin = np.linalg.svd(W, compute_uv=False)[:, -1]
        lo = float((smin * smin).min())
        return 1.0 / lo if lo > 0.0 else float("inf")
    # Gershgorin on the straggler Gram G_S = I_s - W_S^T W_S:
    #   lambda_max(G_S) <= (1 - min_i ||w_i||^2) + (s-1) max_{i!=j} |w_i.w_j|
    norms = np.sum(dropped * dropped, axis=0)
    coh = dropped.T @ dropped
    np.fill_diagonal(coh, 0.0)
    slack = float(norms.min()) - (s - 1) * float(np.abs(coh).max())
    return 1.0 / slack if slack > 0.0 else float("inf")


def exhaustive_max_cond(V: np.ndarray, s: int,
                        budget: int = CERT_BUDGET) -> float:
    """Exact sup of ``cond(V_F V_F^T)`` over every straggler set of size
    ``<= s`` for an *arbitrary* ``V`` (rows need not be orthonormal).

    Used to certify small base codes for :class:`BlockCompositeCode` (the
    per-tile solve is base-sized, so the base certificate is the composite
    certificate) and as the brute-force cross-check for
    :func:`certified_max_cond` in the tests.  Enumerates all
    ``sum_t C(n, t)`` patterns; returns ``inf`` when that exceeds the
    budget or any pattern is numerically singular.
    """
    n = V.shape[1]
    if not 0 <= s < n:
        raise ValueError(f"need 0 <= s < n, got s={s}, n={n}")
    if sum(math.comb(n, t) for t in range(s + 1)) > budget:
        return float("inf")
    worst = 1.0
    cols = np.arange(n)
    for t in range(s + 1):
        for st in itertools.combinations(range(n), t):
            VF = V[:, np.setdiff1d(cols, st)]
            c = float(np.linalg.cond(VF @ VF.T))
            if not math.isfinite(c):
                return float("inf")
            worst = max(worst, c)
    return worst


@lru_cache(maxsize=512)
def certified_cond(family: str, n: int, s: int, seed: int = 0,
                   budget: int = CERT_BUDGET) -> float:
    """Cached certified conditioning of a stable family at ``(n, s)``.

    Dispatches to the closed-form/enumerated orthonormal-row certificate for
    ``chebyshev`` / ``rotation``; ``block`` is certified per base code via
    :func:`exhaustive_max_cond` (see :func:`block_certified_cond`).
    """
    if family in ("chebyshev", "rotation"):
        return certified_max_cond(dropped_rows(family, n, s, seed),
                                  budget=budget)
    raise ValueError(
        f"certified_cond covers 'chebyshev'/'rotation'; for 'block' pass "
        f"the base code to block_certified_cond (got {family!r})")


@lru_cache(maxsize=512)
def block_certified_cond(n0: int, d: int, s: int, m: int,
                         kind: str = "poly", seed: int = 0,
                         budget: int = CERT_BUDGET) -> float:
    """Certified conditioning of a block composite = exact sup over the
    *base* code's straggler sets (per-tile decode never solves a larger
    system; a global budget of ``s`` stragglers puts at most ``s`` in any
    tile)."""
    base = GradCode(n=n0, d=d, s=s, m=m, kind=kind, seed=seed)
    return exhaustive_max_cond(base.V, s, budget=budget)


@lru_cache(maxsize=512)
def classic_certified_cond(n: int, s: int, kind: str | None = None,
                           seed: int = 0, budget: int = 4096) -> float:
    """Certified conditioning of the classic (poly / random) V at ``(n, s)``.

    The classic families carry no closed-form certificate, so this is the
    exhaustive small-n enumeration (:func:`exhaustive_max_cond`): exact at
    the paper-scale n where those families are used, honestly ``inf`` at
    large n — which is precisely where the planner's ``max_cond`` gate
    should push the search toward the stable families.  ``kind=None``
    follows :func:`repro.core.schemes.make_code`'s stability-driven default.
    """
    if kind is None:
        kind = "poly" if n <= 20 else "random"
    V = (polynomial.vandermonde(n, s) if kind == "poly"
         else random_code.gaussian_V(n, s, seed))
    return exhaustive_max_cond(V, s, budget=budget)


def certified_decode_err_bound(code, cond_bound: float | None = None) -> float:
    """Conservative certified bound on the worst relative decode error.

    Forward-error model in float64: encode loses ``eps * max|P|`` per
    coefficient (the wire sums ``d`` of them), and the decode solve amplifies
    by at most ``sqrt(cond)``; with ``n`` terms in the reconstruction the
    bound is

        ``eps * n * d * (1 + max|P|) * (1 + sqrt(cond))``.

    ``cond_bound`` defaults to the construction's certified conditioning
    (``inf`` for uncertified codes, making the bound honestly vacuous).
    Deliberately loose — its job is to be *sound*, so the property suite can
    assert measured error stays below it for every certified construction.
    """
    if cond_bound is None:
        cond_bound = certified_cond_of(code)
    if not math.isfinite(cond_bound):
        return float("inf")
    pmax = float(np.abs(code.P).max())
    return (EPS * code.n * code.d * (1.0 + pmax)
            * (1.0 + math.sqrt(cond_bound)))


def certified_cond_of(code) -> float:
    """Certified conditioning of a concrete scheme object.

    Stable families get their closed-form/enumerated certificate; everything
    else (poly / random / hetero / approx) gets the exhaustive small-n
    certificate when enumerable and ``inf`` otherwise.
    """
    if isinstance(code, BlockCompositeCode):
        base = code.base
        return block_certified_cond(base.n, base.d, base.s, base.m,
                                    kind=base.kind, seed=base.seed)
    kind = getattr(code, "kind", "")
    if kind in ("chebyshev", "rotation"):
        return certified_cond(kind, code.n, code.s,
                              seed=getattr(code, "seed", 0))
    if kind in ("poly", "random"):
        return classic_certified_cond(code.n, code.s, kind,
                                      seed=getattr(code, "seed", 0))
    V = getattr(code, "V", None)
    if V is None:
        return float("inf")
    return exhaustive_max_cond(V, code.s, budget=4096)


# -------------------------------------------------------- block composition
@dataclasses.dataclass(frozen=True)
class BlockCompositeCode:
    """Blockwise 2D composition: ``blocks`` independent tiles of a base code.

    ``n = base.n * blocks`` workers arrange as a ``(blocks x base.n)`` grid;
    tile ``t`` owns subsets ``t*k0 .. (t+1)*k0 - 1`` and runs the base
    ``(n0, d, s, m)`` code on them, so

    - encode/decode coefficients are the base's, tiled — ``P`` is block
      diagonal, ``C`` repeats per tile;
    - decode factors per tile: no solve ever exceeds ``n0 = base.n`` rows,
      which is the whole point — any base inside its stable range keeps the
      composite stable at arbitrary ``n``;
    - a global budget of ``s = base.s`` stragglers puts at most ``s`` in any
      tile, so exact decode is guaranteed at the same frontier ``d = s + m``
      (and, like the repetition family, many past-budget patterns still
      decode exactly when no single tile is over-subscribed);
    - the partial certificate is the max over tiles: the residual operator
      is block diagonal, so the composite ``err_factor`` is the largest
      per-tile factor.

    Duck-compatible with :class:`repro.core.schemes.GradCode` everywhere the
    runtime touches a code (``C``/``P``/``placement``/``slot_mask``/
    ``decode_weights``/``partial_decode_weights``/oracle/``loads``/...).
    """

    base: GradCode
    blocks: int

    def __post_init__(self):
        """Validate the tiling (at least 2 tiles of a valid base code)."""
        if self.blocks < 2:
            raise ValueError(
                f"block composition needs >= 2 tiles, got {self.blocks} "
                f"(use the base code directly for 1)")
        if self.base.num_subsets != self.base.n:
            raise ValueError("base code must have k = n subsets")

    # ---- structural accessors
    @property
    def n(self) -> int:
        """Total workers across all tiles."""
        return self.base.n * self.blocks

    @property
    def n0(self) -> int:
        """Tile size — the largest system decode ever solves."""
        return self.base.n

    @property
    def d(self) -> int:
        """Per-worker computation load (the base code's)."""
        return self.base.d

    @property
    def s(self) -> int:
        """Guaranteed-exact straggler tolerance (any ``s`` global
        stragglers leave every tile within its own budget)."""
        return self.base.s

    @property
    def m(self) -> int:
        """Communication reduction (the base code's)."""
        return self.base.m

    @property
    def kind(self) -> str:
        """Cache-key identity: ``block-<base kind>``."""
        return f"block-{self.base.kind}"

    @property
    def seed(self) -> int:
        """Cache-key identity: the base code's seed."""
        return self.base.seed

    @property
    def num_subsets(self) -> int:
        """Data subsets k = blocks * base.k (= n for a k = n0 base)."""
        return self.blocks * self.base.num_subsets

    @property
    def loads(self) -> tuple[int, ...]:
        """Per-worker subset counts — every worker holds d."""
        return (self.d,) * self.n

    @property
    def comm_fraction(self) -> float:
        """Per-worker transmitted fraction of l (the paper's 1/m)."""
        return 1.0 / self.m

    def placement(self) -> np.ndarray:
        """(n, d) subset ids per worker: the base placement, offset per
        tile into that tile's contiguous subset range."""
        k0 = self.base.num_subsets
        base_pl = self.base.placement()
        tiles = [base_pl + t * k0 for t in range(self.blocks)]
        return np.concatenate(tiles, axis=0)

    def slot_mask(self) -> np.ndarray:
        """(n, d) bool validity of each placement slot (all True)."""
        return np.ones((self.n, self.d), dtype=bool)

    @cached_property
    def assignment(self) -> np.ndarray:
        """(n, k) bool: worker i holds subset j (block diagonal)."""
        out = np.zeros((self.n, self.num_subsets), dtype=bool)
        np.put_along_axis(out, self.placement(), True, axis=1)
        return out

    @cached_property
    def C(self) -> np.ndarray:
        """(n, d, m) encode coefficients — the base's, repeated per tile."""
        return np.tile(self.base.C, (self.blocks, 1, 1))

    @cached_property
    def P(self) -> np.ndarray:
        """(m*k, n) block-diagonal full coefficient matrix."""
        k0, n0, m = self.base.num_subsets, self.base.n, self.m
        P = np.zeros((m * self.num_subsets, self.n), dtype=np.float64)
        for t in range(self.blocks):
            P[t * m * k0:(t + 1) * m * k0, t * n0:(t + 1) * n0] = self.base.P
        return P

    # ---------------------------------------------------------------- decode
    def _per_tile_responders(self, responders) -> list[np.ndarray]:
        """Split a global responder set into local per-tile index arrays."""
        responders = np.asarray(list(responders))
        if responders.dtype == bool:
            responders = np.nonzero(responders)[0]
        responders = np.sort(responders.astype(int))
        n0 = self.base.n
        return [responders[(responders >= t * n0)
                           & (responders < (t + 1) * n0)] - t * n0
                for t in range(self.blocks)]

    def decode_weights(self, responders) -> np.ndarray:
        """(n, m) float64 W, zero rows at stragglers — the base decode per
        tile, stacked.  Exact whenever every tile retains at least
        ``n0 - s`` responders (in particular for any <= s global
        stragglers); an over-subscribed tile raises with the standard
        "pass partial=True" hint."""
        W = np.zeros((self.n, self.m), dtype=np.float64)
        n0 = self.base.n
        for t, local in enumerate(self._per_tile_responders(responders)):
            W[t * n0:(t + 1) * n0] = self.base.decode_weights(local)
        return W

    def partial_decode_weights(self, responders) -> tuple[np.ndarray, float]:
        """Per-tile least-squares weights + the max per-tile certificate.

        The residual operator is block diagonal, so the composite L2 decode
        error is bounded by ``max_t err_factor_t * sqrt(sum_j ||g_j||^2)``
        — exactly 0.0 whenever every tile decodes exactly.
        """
        W = np.zeros((self.n, self.m), dtype=np.float64)
        n0 = self.base.n
        worst = 0.0
        for t, local in enumerate(self._per_tile_responders(responders)):
            Wt, ft = self.base.partial_decode_weights(local)
            W[t * n0:(t + 1) * n0] = Wt
            worst = max(worst, float(ft))
        return W, worst

    # ------------------------------------------------------- numpy reference
    def encode(self, G: np.ndarray) -> np.ndarray:
        """Reference encoder: G (k, l) per-subset gradients -> F (n, l/m)
        (the base encoder per tile)."""
        k, l = G.shape
        assert k == self.num_subsets and l % self.m == 0
        k0, n0 = self.base.num_subsets, self.base.n
        F = np.zeros((self.n, l // self.m), dtype=G.dtype)
        for t in range(self.blocks):
            F[t * n0:(t + 1) * n0] = self.base.encode(
                G[t * k0:(t + 1) * k0])
        return F

    def decode(self, F: np.ndarray, responders, *,
               partial: bool = False) -> np.ndarray:
        """Reference decoder: F (n, l/m) -> (l,) sum gradient over all
        tiles' subsets."""
        if partial:
            W, _ = self.partial_decode_weights(responders)
        else:
            W = self.decode_weights(responders)
        decoded = np.einsum("nv,nu->vu", F, W)
        return decoded.reshape(-1)

    # ----------------------------------------------------------------- misc
    def describe(self) -> str:
        """One-line human-readable summary of the composition."""
        return (f"BlockCompositeCode(n={self.n}, d={self.d}, s={self.s}, "
                f"m={self.m}, tiles={self.blocks} x n0={self.n0}, "
                f"base={self.base.kind}) — per-tile decode never exceeds "
                f"n0={self.n0}; exact for any {self.s} global stragglers")


# ----------------------------------------------------------------- factories
def make_stable(family: str, n: int, d: int, s: int, m: int, *,
                n0: int | None = None, seed: int = 0):
    """Materialise a stable family by name — the planner/trainer seam.

    ``chebyshev`` / ``rotation`` return a :class:`GradCode` of that kind
    (the construction is recoverable from ``(family, n, d, s, m)`` and the
    pinned default seed, like the approx families).  ``block`` additionally
    needs the tile size ``n0`` (must divide ``n``) and tiles the default
    small-n base kind (polynomial for ``n0 <= 20``).

    >>> code = make_stable("rotation", 16, 4, 2, 2)
    >>> code.kind, code.n
    ('rotation', 16)
    >>> comp = make_stable("block", 16, 3, 1, 2, n0=8)
    >>> comp.n0, comp.blocks
    (8, 2)
    """
    if family in ("chebyshev", "rotation"):
        return GradCode(n=n, d=d, s=s, m=m, kind=family, seed=seed)
    if family == "block":
        if n0 is None or n0 < 2 or n % n0:
            raise ValueError(
                f"block composition needs a tile size n0 >= 2 dividing "
                f"n={n}, got n0={n0}")
        base = make_code(n0, d, s, m, seed=seed)
        return BlockCompositeCode(base=base, blocks=n // n0)
    raise ValueError(
        f"unknown stable family {family!r}; expected one of "
        f"{STABLE_FAMILIES}")


#: Largest tile size the block-composite candidate search offers: small
#: enough that the base certificate is exhaustively enumerable and the
#: per-tile solve is trivially stable.
MAX_BLOCK_TILE = 16


def stable_candidates(family: str, n: int, seed: int = 0,
                      budget: int = CERT_BUDGET):
    """Yield ``(d, s, m, n0, cond)`` for every *certified* construction of a
    stable family at ``n`` workers — the planner's search space.

    Only certified candidates are yielded (``cond < inf``): for the
    orthonormal-row families that is every ``s`` whose ``C(n, s)``
    enumeration fits the budget; for ``block`` every tile size
    ``n0 | n`` up to :data:`MAX_BLOCK_TILE` with an enumerable base.
    ``n0`` is ``None`` for the non-composite families.
    """
    if family in ("chebyshev", "rotation"):
        for s in range(0, n):
            cond = certified_cond(family, n, s, seed=seed, budget=budget)
            if not math.isfinite(cond):
                continue     # uncertified at this s — never admitted
            for m in range(1, n - s + 1):
                yield s + m, s, m, None, cond
        return
    if family == "block":
        for n0 in range(2, min(n // 2, MAX_BLOCK_TILE) + 1):
            if n % n0:
                continue
            for d in range(1, n0 + 1):
                for m in range(1, d + 1):
                    s = d - m
                    # tiles are <= MAX_BLOCK_TILE <= 20, so make_code's
                    # default base kind is always the polynomial one
                    cond = block_certified_cond(n0, d, s, m, kind="poly",
                                                seed=seed, budget=budget)
                    if math.isfinite(cond):
                        yield d, s, m, n0, cond
        return
    raise ValueError(
        f"unknown stable family {family!r}; expected one of "
        f"{STABLE_FAMILIES}")
