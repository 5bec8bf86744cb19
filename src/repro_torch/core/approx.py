"""Approximate gradient-coding families: certified error from *any* pattern.

The paper's exact (d, s, m) codes pay a dense Vandermonde encode and decode
exactly only while at most ``s`` workers straggle.  The two families here
trade exactness past a structural threshold for

- a **sparse 0/1 encode** (one nonzero per placement slot — no polynomial
  solve, no dense ``B @ V`` product, numerically exact at any ``n``), and
- a **certified decode from every straggler pattern**: ``
  partial_decode_weights`` returns the same ``(W, err_factor)`` contract as
  :func:`repro.core.hetero.partial_decode_weights` — the L2 decode error is
  bounded by ``err_factor * sqrt(sum_j ||g_j||^2)`` for every gradient
  realisation — so both ride the existing ``SchemeSpec`` / packed-wire /
  ``make_coded_train_step(partial=True)`` paths unchanged.

**FractionalRepetitionCode** (Tandon et al.; error analysis in Wang, Liu &
Shroff, "Fundamental Limits of Approximate Gradient Coding").  Workers are
partitioned into blocks of ``m * (s+1)`` — per block, ``m`` *phases* (which
of the m gradient coordinates modulo m the worker transmits) times ``s+1``
identical *clones*.  A (block, phase) cell is a **repetition group**: decode
is exact (weight-1 selection, bitwise-clean coefficients) whenever every
group has at least one responder, i.e. for *any* ``s`` stragglers and for
most larger patterns.  Dead groups have an optimal closed-form certificate
``err_factor = sqrt(d * max_u dead_groups(u))`` — their rows vanish from the
live system, so no least-squares solve can do better.

**ExpanderCode** (regular-graph assignment; Raviv et al., Wang et al., and
"Communication-Efficient Approximate Gradient Coding", Munim &
Ramamoorthy, keep the m-split wire).  Each of the ``m`` phase classes gets a
seeded ``c``-regular bipartite graph between the ``k`` subsets and its
``n/m`` workers; decode at full response is the uniform ``1/c`` average, and
any straggler pattern decodes by least squares with the generic certificate.
The worst-case certificate over all patterns of ``t`` stragglers is bounded
in closed form from the **spectral gap** of the assignment graph
(:meth:`ExpanderCode.worst_err_bound`, an expander-mixing argument): good
expansion means a dead worker's subsets are spread thin, so the residual
grows like ``sqrt(d * t / c)`` instead of concentrating.

The planner consumes ``worst_err_bound`` to rank approx candidates under an
error ceiling (``rank_plans(approx_options=..., max_err=...)``).
"""
from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np

from .hetero import partial_decode_weights as _lstsq_decode_weights

#: The family names the planner / trainer recognise, in default search order.
APPROX_FAMILIES = ("frc", "expander")


# ------------------------------------------------------------ shared helpers
def _phase_of(n: int, m: int) -> np.ndarray:
    """(n,) phase id per worker: worker ``i`` transmits coordinate block
    ``i % m`` of the m-split wire (phases interleave across worker ids so a
    contiguous straggler burst spreads over phases)."""
    return np.arange(n) % m


def _onehot_C(n: int, d: int, m: int, phases: np.ndarray) -> np.ndarray:
    """(n, d, m) float64 encode coefficients with a single 1.0 per slot:
    worker ``i`` sums coordinate ``phases[i]`` of each held subset."""
    C = np.zeros((n, d, m), dtype=np.float64)
    C[np.arange(n), :, phases] = 1.0
    return C


def _build_P(k: int, m: int, placement: np.ndarray,
             phases: np.ndarray) -> np.ndarray:
    """(m*k, n) coefficient matrix ``P[j*m + u, i] = C`` support — the input
    to the generic least-squares certificate solve."""
    n = placement.shape[0]
    P = np.zeros((m * k, n), dtype=np.float64)
    for i in range(n):
        for j in placement[i]:
            P[int(j) * m + int(phases[i]), i] = 1.0
    return P


def _as_responder_indices(responders, n: int) -> np.ndarray:
    """Normalise a responder list / bool mask to sorted int indices."""
    responders = np.asarray(responders)
    if responders.dtype == bool:
        responders = np.nonzero(responders)[0]
    return np.sort(responders).astype(int)


def _reference_encode(code, G: np.ndarray) -> np.ndarray:
    """Shared numpy oracle encoder: G (k, l) -> F (n, l/m) via ``code.C``."""
    k, l = G.shape
    assert k == code.num_subsets and l % code.m == 0
    Gr = G.reshape(k, l // code.m, code.m)
    F = np.zeros((code.n, l // code.m), dtype=G.dtype)
    placement = code.placement()
    for i in range(code.n):
        for slot in range(code.d):
            j = placement[i, slot]
            F[i] += np.einsum("vu,u->v", Gr[j], code.C[i, slot])
    return F


def _reference_decode(code, F: np.ndarray, responders, *,
                      partial: bool) -> np.ndarray:
    """Shared numpy oracle decoder: F (n, l/m) -> (l,) sum gradient."""
    if partial:
        W, _ = code.partial_decode_weights(responders)
    else:
        W = code.decode_weights(responders)
    decoded = np.einsum("nv,nu->vu", F, W)
    return decoded.reshape(-1)


# -------------------------------------------------- fractional repetition
@dataclasses.dataclass(frozen=True)
class FractionalRepetitionCode:
    """Block-repetition approximate code with the ``GradCode`` runtime surface.

    ``n`` workers split into ``n / (m * (s+1))`` blocks; block ``b`` owns
    subsets ``b*d .. b*d + d - 1`` and its ``m * (s+1)`` workers pair a
    *phase* ``u`` (which of the m wire coordinates they transmit) with a
    *clone* index — the ``s+1`` clones of a (block, phase) cell transmit
    identical encodings, so one live clone per cell reconstructs the sum
    with weight-1.0 selection (bitwise-exact arithmetic, no solve).

    Duck-compatible with :class:`repro.core.schemes.GradCode` everywhere the
    runtime touches a code: ``n``/``d``/``s``/``m``, sparse ``C``,
    ``placement()``/``slot_mask()``, ``decode_weights`` /
    ``partial_decode_weights``, the numpy ``encode``/``decode`` oracle, and
    ``num_subsets``/``loads``/``comm_fraction``/``describe``.

    ``d`` defaults to ``m * (s+1)`` so ``k = num_subsets = n`` — the same
    batch-divisibility contract as the paper's uniform scheme.
    """

    n: int
    s: int          # straggler budget: s+1 clones per repetition group
    m: int
    d: int = 0      # subsets per worker (0 -> default m * (s+1), k = n)

    def __post_init__(self):
        """Validate the block structure (n must tile into m*(s+1) cells)."""
        if self.n < 1 or self.m < 1 or self.s < 0:
            raise ValueError(f"invalid parameters {self}")
        group = self.m * (self.s + 1)
        if self.n % group:
            raise ValueError(
                f"frc needs n divisible by m*(s+1) = {group}, got n={self.n}")
        if self.d == 0:
            object.__setattr__(self, "d", group)
        if self.d < 1:
            raise ValueError(f"invalid per-worker load d={self.d}")

    # ---- structural accessors
    @property
    def replication(self) -> int:
        """Clones per repetition group (= s + 1)."""
        return self.s + 1

    @property
    def n_blocks(self) -> int:
        """Number of worker blocks (each owning ``d`` subsets)."""
        return self.n // (self.m * self.replication)

    @property
    def num_subsets(self) -> int:
        """Number of equal-size data subsets k = n_blocks * d."""
        return self.n_blocks * self.d

    @property
    def num_groups(self) -> int:
        """Number of repetition groups (= (block, phase) cells)."""
        return self.n_blocks * self.m

    @property
    def loads(self) -> tuple[int, ...]:
        """Per-worker subset counts — every worker holds d."""
        return (self.d,) * self.n

    @property
    def comm_fraction(self) -> float:
        """Per-worker transmitted fraction of l (the paper's 1/m)."""
        return 1.0 / self.m

    @cached_property
    def phases(self) -> np.ndarray:
        """(n,) wire coordinate (mod m) each worker transmits."""
        return (np.arange(self.n) % (self.m * self.replication)) % self.m

    @cached_property
    def groups(self) -> np.ndarray:
        """(n,) repetition-group id of each worker: ``block * m + phase`` —
        the s+1 members of a group transmit identical encodings."""
        block = np.arange(self.n) // (self.m * self.replication)
        return block * self.m + self.phases

    def placement(self) -> np.ndarray:
        """(n, d) subset ids per worker (its block's contiguous range)."""
        block = np.arange(self.n) // (self.m * self.replication)
        return block[:, None] * self.d + np.arange(self.d)[None, :]

    def slot_mask(self) -> np.ndarray:
        """(n, d) bool validity of each placement slot (all True)."""
        return np.ones((self.n, self.d), dtype=bool)

    @cached_property
    def assignment(self) -> np.ndarray:
        """(n, k) bool: worker i holds subset j."""
        out = np.zeros((self.n, self.num_subsets), dtype=bool)
        np.put_along_axis(out, self.placement(), True, axis=1)
        return out

    @cached_property
    def C(self) -> np.ndarray:
        """(n, d, m) encode coefficients — exactly one 1.0 per slot."""
        return _onehot_C(self.n, self.d, self.m, self.phases)

    @cached_property
    def P(self) -> np.ndarray:
        """(m*k, n) full coefficient matrix (column i = worker i)."""
        return _build_P(self.num_subsets, self.m, self.placement(),
                        self.phases)

    # ---------------------------------------------------------------- decode
    def _select_weights(self, responders) -> tuple[np.ndarray, int]:
        """Weight-1.0 selection of one live clone per repetition group.

        Returns ``(W, dead)`` where ``dead`` is the worst per-phase count of
        groups with no live clone (the certificate's only ingredient).
        """
        F = _as_responder_indices(responders, self.n)
        live = np.zeros(self.n, dtype=bool)
        live[F] = True
        W = np.zeros((self.n, self.m), dtype=np.float64)
        dead_per_phase = np.zeros(self.m, dtype=int)
        groups, phases = self.groups, self.phases
        for g in range(self.num_groups):
            members = np.nonzero(groups == g)[0]
            alive = members[live[members]]
            if len(alive):
                W[alive[0], phases[alive[0]]] = 1.0
            else:
                dead_per_phase[g % self.m] += 1
        return W, int(dead_per_phase.max()) if self.m else 0

    def decode_weights(self, responders) -> np.ndarray:
        """(n, m) float64 selection weights; exact whenever every repetition
        group has a live clone (in particular for any <= s stragglers).
        Raises when a group went fully dark — pass ``partial=True`` paths
        for the certified estimate instead."""
        W, dead = self._select_weights(responders)
        if dead:
            raise ValueError(
                f"{dead} repetition group(s) have no responder; pass "
                f"partial=True to decode a certified approximation")
        return W

    def partial_decode_weights(self, responders) -> tuple[np.ndarray, float]:
        """Selection weights + closed-form certificate for *any* responder
        set.  Dead groups' rows vanish from the live system (all their
        holders straggled), so the selection decode is already the
        least-squares optimum and the certificate is exact:
        ``err_factor = sqrt(d * max_u dead_groups(u)) = sigma_max(PW - 1xI)``
        — exactly 0.0 whenever every group has a responder."""
        W, dead = self._select_weights(responders)
        return W, math.sqrt(self.d * dead)

    def worst_err_bound(self, t: int) -> float:
        """Worst-case certificate over *all* patterns of ``t`` stragglers.

        Killing one group costs s+1 stragglers; an adversary concentrates
        kills in a single phase, so at most ``min(t // (s+1), n_blocks)``
        same-phase groups die and the certificate never exceeds
        ``sqrt(d * that)``.  Exactly 0.0 for ``t <= s``.
        """
        t = int(t)
        if t < 0:
            raise ValueError(f"straggler count must be >= 0, got {t}")
        dead = min(t // self.replication, self.n_blocks)
        return math.sqrt(self.d * dead)

    # ------------------------------------------------------- numpy reference
    def encode(self, G: np.ndarray) -> np.ndarray:
        """Reference encoder: G (k, l) per-subset gradients -> F (n, l/m)."""
        return _reference_encode(self, G)

    def decode(self, F: np.ndarray, responders, *,
               partial: bool = False) -> np.ndarray:
        """Reference decoder: F (n, l/m) -> (l,) sum gradient (selection
        weights; with ``partial=True`` dead groups are dropped and the
        result carries the :meth:`partial_decode_weights` certificate)."""
        return _reference_decode(self, F, responders, partial=partial)

    # ----------------------------------------------------------------- misc
    def describe(self) -> str:
        """One-line human-readable summary of the code."""
        return (f"FractionalRepetitionCode(n={self.n}, d={self.d}, "
                f"s={self.s}, m={self.m}, k={self.num_subsets}) — "
                f"{self.n_blocks} block(s) x {self.m} phase(s) x "
                f"{self.replication} clone(s); exact for any {self.s} "
                f"stragglers, certified estimate from any pattern")


# ------------------------------------------------------------ expander code
@dataclasses.dataclass(frozen=True)
class ExpanderCode:
    """Seeded regular-graph approximate code with the ``GradCode`` surface.

    Per wire phase ``u`` the ``n/m`` phase-``u`` workers are connected to
    the ``k`` subsets by a seeded ``c``-regular bipartite graph (every
    subset held by exactly ``c`` same-phase workers, every worker holding
    ``d`` distinct subsets).  Full response decodes with the uniform
    ``1/c`` average (``err_factor`` exactly 0.0); any straggler pattern
    decodes by least squares with the generic certificate, and
    :meth:`worst_err_bound` bounds the certificate over all patterns of a
    given size via the graph's spectral gap (expander mixing: well-spread
    assignments cannot concentrate residual mass).

    Exact decode is only *guaranteed* at full response (``s = 0``): unlike
    the repetition family, per-subset liveness does not imply a consistent
    selection, so the family is honestly approximate past zero stragglers.

    ``d`` defaults to ``m * c`` so ``k = num_subsets = n``, matching the
    uniform scheme's batch-divisibility contract.  Construction is a
    seeded configuration model with a deterministic cyclic fallback —
    byte-identical across processes for equal ``(n, c, m, d, seed)``.
    """

    n: int
    c: int          # holders per (subset, phase) cell
    m: int
    seed: int = 0
    d: int = 0      # subsets per worker (0 -> default m * c, k = n)

    def __post_init__(self):
        """Validate the per-phase regular-graph shape constraints."""
        if self.n < 1 or self.m < 1 or self.c < 1:
            raise ValueError(f"invalid parameters {self}")
        if self.n % self.m:
            raise ValueError(
                f"expander needs n divisible by m, got n={self.n} m={self.m}")
        if self.d == 0:
            object.__setattr__(self, "d", self.m * self.c)
        n_u = self.n // self.m
        if self.c > n_u:
            raise ValueError(
                f"cell replication c={self.c} exceeds phase size {n_u}")
        if (n_u * self.d) % self.c:
            raise ValueError(
                f"per-phase edge count {n_u}*{self.d} must divide by c={self.c}")
        if self.d > self.num_subsets:
            raise ValueError(
                f"d={self.d} exceeds k={self.num_subsets} distinct subsets")

    # ---- structural accessors
    @property
    def s(self) -> int:
        """Guaranteed-exact straggler tolerance: 0 — the family is
        approximate past full response (use the partial certificate)."""
        return 0

    @property
    def phase_size(self) -> int:
        """Workers per wire phase (n / m)."""
        return self.n // self.m

    @property
    def num_subsets(self) -> int:
        """Number of equal-size data subsets k = (n/m) * d / c."""
        return (self.phase_size * self.d) // self.c

    @property
    def loads(self) -> tuple[int, ...]:
        """Per-worker subset counts — every worker holds d."""
        return (self.d,) * self.n

    @property
    def comm_fraction(self) -> float:
        """Per-worker transmitted fraction of l (the paper's 1/m)."""
        return 1.0 / self.m

    @cached_property
    def phases(self) -> np.ndarray:
        """(n,) wire coordinate (mod m) each worker transmits."""
        return _phase_of(self.n, self.m)

    @cached_property
    def _phase_placement(self) -> np.ndarray:
        """(n/m, d, m) per-phase worker->subset table (seeded, deterministic).

        Configuration model: ``c`` stubs per subset are shuffled and dealt
        ``d`` at a time to the phase's workers; rows with duplicate subsets
        reject the attempt.  After 200 rejected shuffles the build falls
        back to the deterministic cyclic-window graph (worker ``w`` takes
        ``d`` consecutive subsets from offset ``w*d + u``) — a weaker
        expander but always valid.
        """
        k, n_u, d, c = self.num_subsets, self.phase_size, self.d, self.c
        rng = np.random.default_rng(self.seed)
        out = np.zeros((n_u, d, self.m), dtype=int)
        for u in range(self.m):
            table = None
            for _ in range(200):
                stubs = np.repeat(np.arange(k), c)
                rng.shuffle(stubs)
                cand = stubs.reshape(n_u, d)
                if all(len(np.unique(row)) == d for row in cand):
                    table = np.sort(cand, axis=1)
                    break
            if table is None:   # cyclic fallback: still c-regular, d-distinct
                table = np.sort(
                    (np.arange(n_u)[:, None] * d + u
                     + np.arange(d)[None, :]) % k, axis=1)
            out[:, :, u] = table
        return out

    def placement(self) -> np.ndarray:
        """(n, d) subset ids per worker (its phase graph's neighbourhood)."""
        out = np.zeros((self.n, self.d), dtype=int)
        for i in range(self.n):
            out[i] = self._phase_placement[i // self.m, :, i % self.m]
        return out

    def slot_mask(self) -> np.ndarray:
        """(n, d) bool validity of each placement slot (all True)."""
        return np.ones((self.n, self.d), dtype=bool)

    @cached_property
    def assignment(self) -> np.ndarray:
        """(n, k) bool: worker i holds subset j."""
        out = np.zeros((self.n, self.num_subsets), dtype=bool)
        np.put_along_axis(out, self.placement(), True, axis=1)
        return out

    @cached_property
    def C(self) -> np.ndarray:
        """(n, d, m) encode coefficients — exactly one 1.0 per slot."""
        return _onehot_C(self.n, self.d, self.m, self.phases)

    @cached_property
    def P(self) -> np.ndarray:
        """(m*k, n) full coefficient matrix (column i = worker i)."""
        return _build_P(self.num_subsets, self.m, self.placement(),
                        self.phases)

    @cached_property
    def spectral_gaps(self) -> tuple[float, ...]:
        """Second singular value of each phase's (k, n/m) biadjacency —
        the expander-quality input to :meth:`worst_err_bound` (the top
        singular value is always ``sqrt(c * d)`` by regularity)."""
        out = []
        for u in range(self.m):
            H = np.zeros((self.num_subsets, self.phase_size))
            for w in range(self.phase_size):
                H[self._phase_placement[w, :, u], w] = 1.0
            sv = np.linalg.svd(H, compute_uv=False)
            out.append(float(sv[1]) if len(sv) > 1 else 0.0)
        return tuple(out)

    # ---------------------------------------------------------------- decode
    def _uniform_weights(self) -> np.ndarray:
        """The full-response decode: every worker weighted 1/c on its phase."""
        W = np.zeros((self.n, self.m), dtype=np.float64)
        W[np.arange(self.n), self.phases] = 1.0 / self.c
        return W

    def decode_weights(self, responders) -> np.ndarray:
        """(n, m) float64 uniform 1/c weights — exact, but only guaranteed
        for the full responder set (s = 0); any straggler raises (use the
        partial path for the certified estimate)."""
        F = _as_responder_indices(responders, self.n)
        if len(F) < self.n:
            raise ValueError(
                f"expander decode is exact only at full response "
                f"(n={self.n}, got {len(F)}); pass partial=True to decode "
                f"a certified approximation")
        return self._uniform_weights()

    def partial_decode_weights(self, responders) -> tuple[np.ndarray, float]:
        """Least-squares weights + certificate for *any* responder set.

        Full response short-circuits to the uniform 1/c weights with
        ``err_factor`` exactly 0.0 (no solve); otherwise the generic
        :func:`repro.core.hetero.partial_decode_weights` least-squares
        certificate runs on the sparse ``P``.
        """
        F = _as_responder_indices(responders, self.n)
        if len(F) == self.n:
            return self._uniform_weights(), 0.0
        return _lstsq_decode_weights(self.P, self.n, self.m, F)

    def worst_err_bound(self, t: int) -> float:
        """Spectral-gap worst-case certificate over all ``t``-straggler sets.

        Dropping a straggler's weight leaves residual ``miss_j / c`` on each
        of its subsets (``miss_j`` = dead holders of subset j, <= c).  The
        least-squares certificate can only be smaller, and two rigorous
        bounds cap the dropped-weight residual:

        - **degree bound** ``sqrt(d * t / c)``: the t stragglers kill
          ``d*t`` subset-edges in total, each contributing at most ``c``;
        - **mixing bound** per phase: with ``x`` dead workers in a phase of
          size ``n_u``, ``||H x_S|| <= c*x*sqrt(k)/n_u + lambda *
          sqrt(x(1 - x/n_u))`` where ``lambda`` is the phase graph's second
          singular value — a good expander spreads the damage.

        Returns the minimum of the two (and the trivial ``sqrt(k*m)`` cap),
        maximised over how an adversary splits ``t`` across phases.
        Exactly 0.0 at ``t = 0``.
        """
        t = int(t)
        if t < 0:
            raise ValueError(f"straggler count must be >= 0, got {t}")
        t = min(t, self.n)
        if t == 0:
            return 0.0
        k, n_u, d, c = self.num_subsets, self.phase_size, self.d, self.c
        degree_sq = d * t / c
        per_phase_sq = 0.0
        for lam in self.spectral_gaps:
            cap = min(t, n_u)
            best = 0.0
            for x in range(cap + 1):
                mix = (c * x * math.sqrt(k) / n_u
                       + lam * math.sqrt(max(x * (1.0 - x / n_u), 0.0))) / c
                best = max(best, min(d * x / c, mix * mix, float(k)))
            per_phase_sq += best
        return math.sqrt(min(degree_sq, per_phase_sq, float(k * self.m)))

    # ------------------------------------------------------- numpy reference
    def encode(self, G: np.ndarray) -> np.ndarray:
        """Reference encoder: G (k, l) per-subset gradients -> F (n, l/m)."""
        return _reference_encode(self, G)

    def decode(self, F: np.ndarray, responders, *,
               partial: bool = False) -> np.ndarray:
        """Reference decoder: F (n, l/m) -> (l,) sum gradient (uniform 1/c
        at full response; ``partial=True`` accepts any responder set and
        returns the certified least-squares estimate)."""
        return _reference_decode(self, F, responders, partial=partial)

    # ----------------------------------------------------------------- misc
    def describe(self) -> str:
        """One-line human-readable summary of the code."""
        return (f"ExpanderCode(n={self.n}, d={self.d}, c={self.c}, "
                f"m={self.m}, k={self.num_subsets}, seed={self.seed}) — "
                f"seeded {self.c}-regular phase graphs, spectral gaps "
                f"{tuple(round(g, 3) for g in self.spectral_gaps)}; exact at "
                f"full response, certified estimate from any pattern")


# ----------------------------------------------------------------- factories
def make_frc(n: int, s: int, m: int, d: int | None = None,
             ) -> FractionalRepetitionCode:
    """Factory: (n, s, m) -> :class:`FractionalRepetitionCode`.

    >>> code = make_frc(8, s=1, m=2)
    >>> code.d, code.num_subsets      # d = m*(s+1), k = n
    (4, 8)
    >>> code.worst_err_bound(1)       # any single straggler decodes exactly
    0.0
    """
    return FractionalRepetitionCode(n=n, s=s, m=m, d=0 if d is None else d)


def make_expander(n: int, c: int, m: int, seed: int = 0,
                  d: int | None = None) -> ExpanderCode:
    """Factory: (n, c, m, seed) -> :class:`ExpanderCode`.

    >>> code = make_expander(8, c=2, m=2, seed=0)
    >>> code.d, code.num_subsets      # d = m*c, k = n
    (4, 8)
    >>> code.partial_decode_weights(range(8))[1]   # full response: certified 0
    0.0
    """
    return ExpanderCode(n=n, c=c, m=m, seed=seed, d=0 if d is None else d)


def make_approx(family: str, n: int, replication: int, m: int,
                seed: int = 0):
    """Materialise an approx family by name — the planner/trainer seam.

    ``replication`` is the per-cell holder count: ``s + 1`` clones for
    ``"frc"``, graph degree ``c`` for ``"expander"``.  The per-worker load
    is ``d = m * replication`` for both, so a ranked plan's construction is
    recoverable from its ``(family, d, m)`` alone.
    """
    if family == "frc":
        return make_frc(n, s=replication - 1, m=m)
    if family == "expander":
        return make_expander(n, c=replication, m=m, seed=seed)
    raise ValueError(
        f"unknown approx family {family!r}; expected one of {APPROX_FAMILIES}")


def approx_candidates(family: str, n: int, seed: int = 0):
    """Yield every valid ``(replication, m, code)`` construction of a family
    at ``n`` workers with the default ``d = m * replication`` (k = n) —
    the planner's approx search space.
    """
    if family not in APPROX_FAMILIES:
        raise ValueError(
            f"unknown approx family {family!r}; expected one of "
            f"{APPROX_FAMILIES}")
    for rep in range(1, n + 1):
        for m in range(1, n // rep + 1):
            if family == "frc" and n % (m * rep):
                continue
            if family == "expander" and n % m:
                continue
            try:
                yield rep, m, make_approx(family, n, rep, m, seed=seed)
            except ValueError:
                continue
