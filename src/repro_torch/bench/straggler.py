"""Straggler injection from the Section-VI shifted-exponential model.

Draws per-worker delay/dropout patterns for the end-to-end bench: worker `i`
finishes its `(d, s, m)` round after

    X_i = d * (t1 + Exp(lambda1)) + (t2 + Exp(lambda2)) / m

and the master proceeds once the fastest `n - s` workers are in.  A draw
therefore yields both the modeled cluster wait (the `(n-s)`-th order
statistic, matching `repro.core.runtime_model.simulate_runtimes`) and the
concrete dropout set (the `s` slowest workers) to feed the jitted step's
`W`/`mask`/`rho` inputs.

`draw_patterns_hetero` generalises the draw to heterogeneous clusters:
per-worker subset loads (a `repro.core.hetero.HeteroPlan`'s load vector) and
relative speeds scale the computation term, and `n_drop` lets the
partial-recovery bench drop more than the design `s`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.runtime_model import RuntimeParams


@dataclasses.dataclass(frozen=True)
class StragglerPattern:
    """One iteration's injected delays and the induced dropout set."""

    worker_times: np.ndarray  # (n,) modeled per-worker finish times
    stragglers: tuple[int, ...]  # indices of the s slowest (dropped) workers
    wait_s: float  # modeled master wait: (n-s)-th order statistic


def _patterns_from_times(
    times: np.ndarray, n: int, n_drop: int
) -> list[StragglerPattern]:
    """Order-statistic bookkeeping shared by the homogeneous and
    heterogeneous draws: drop the `n_drop` slowest workers of each row and
    record the `(n - n_drop)`-th order statistic as the master wait."""
    out = []
    for t in times:
        order = np.argsort(t)
        slow = tuple(int(i) for i in order[n - n_drop :]) if n_drop else ()
        out.append(
            StragglerPattern(
                worker_times=t,
                stragglers=slow,
                wait_s=float(t[order[n - n_drop - 1]]),
            )
        )
    return out


def draw_patterns(
    params: RuntimeParams,
    d: int,
    s: int,
    m: int,
    iters: int,
    seed: int = 0,
    n_drop: int | None = None,
) -> list[StragglerPattern]:
    """`iters` i.i.d. delay/dropout patterns for an `(n, d, s, m)` scheme.

    `n_drop` overrides how many of the slowest workers are dropped per draw
    (default: the design `s`) — the partial-recovery bench injects `s + 1`
    and beyond to measure graceful degradation, with the master then waiting
    only for the `n - n_drop` fastest.
    """
    rng = np.random.default_rng(seed)
    n = params.n
    comp = d * (params.t1 + rng.exponential(1.0 / params.lambda1, (iters, n)))
    comm = (params.t2 + rng.exponential(1.0 / params.lambda2, (iters, n))) / m
    return _patterns_from_times(comp + comm, n, s if n_drop is None else n_drop)


def draw_patterns_hetero(
    params: RuntimeParams,
    loads: np.ndarray | list[int],
    k: int,
    s: int,
    m: int,
    iters: int,
    speeds: np.ndarray | list[float] | None = None,
    seed: int = 0,
    n_drop: int | None = None,
    departed: list[int] | tuple[int, ...] = (),
) -> list[StragglerPattern]:
    """Heterogeneous-cluster generalisation of `draw_patterns`.

    Worker `i` holds `loads[i]` of `k` equal data subsets and computes at
    relative speed `speeds[i]` (1.0 = the calibrated `RuntimeParams` rates),
    finishing its round after

        X_i = (loads[i] * n / k) * (t1 + Exp(lambda1)) / speeds[i]
              + (t2 + Exp(lambda2)) / m

    The computation term reduces exactly to the Sec-VI model for the uniform
    scheme (`loads = d * ones`, `k = n`, unit speeds); communication is
    load-independent — every worker transmits the same `l/m` encoding, so
    only the compute side is scaled.  The heterogeneous *plan* equalises
    `loads[i] / speeds[i]`, which keeps the straggler budget `s` available
    for genuine noise instead of burning it on deterministically slow
    workers.

    `departed` names workers that never respond (elastic membership churn):
    their modeled finish time is `+inf`, so they are always among the
    dropped.  Note a *zero-load* departed worker would otherwise look like
    the fastest responder (zero compute), silently corrupting the wait —
    this is why the elastic planner must pass the departed set explicitly.
    """
    rng = np.random.default_rng(seed)
    n = params.n
    loads = np.asarray(loads, dtype=np.float64)
    speeds = np.ones(n) if speeds is None else np.asarray(speeds, dtype=np.float64)
    assert loads.shape == (n,) and speeds.shape == (n,)
    scale = loads * n / (k * speeds)  # (n,)
    comp = scale[None, :] * (
        params.t1 + rng.exponential(1.0 / params.lambda1, (iters, n))
    )
    comm = (params.t2 + rng.exponential(1.0 / params.lambda2, (iters, n))) / m
    total = comp + comm
    if departed:
        dep = sorted({int(i) for i in departed})
        if any(i < 0 or i >= n for i in dep):
            raise ValueError(f"departed indices {dep} out of range 0..{n-1}")
        total[:, dep] = np.inf
    return _patterns_from_times(total, n, s if n_drop is None else n_drop)


def draw_patterns_overlapped(
    params: RuntimeParams,
    d: int,
    s: int,
    m: int,
    iters: int,
    seed: int = 0,
) -> list[StragglerPattern]:
    """Steady-state draws for the *pipelined* step: worker `i`'s cycle time
    is `max(comp_i, comm_i)` — its step-t collective overlaps its step-(t+1)
    compute — so each pattern's wait is the `(n-s)`-th order statistic of
    the per-worker max instead of the sum.  The Monte-Carlo twin of
    `repro.core.runtime_model.expected_total_runtime_overlapped` (same
    component distributions as `draw_patterns`, same seeding layout).
    """
    rng = np.random.default_rng(seed)
    n = params.n
    comp = d * (params.t1 + rng.exponential(1.0 / params.lambda1, (iters, n)))
    comm = (params.t2 + rng.exponential(1.0 / params.lambda2, (iters, n))) / m
    return _patterns_from_times(np.maximum(comp, comm), n, s)


def overlap_fraction(comp_phase_s: float, comm_phase_s: float,
                     pipelined_total_s: float) -> float:
    """How much of the achievable compute/communication overlap the
    pipelined step realises, in [0, 1].

    With per-step phase totals `comp` and `comm`, a fully sequential step
    costs `comp + comm` and a perfectly overlapped one `max(comp, comm)`;
    the fraction locates the measured pipelined total between the two:

        (comp + comm - pipelined) / (comp + comm - max(comp, comm))

    clipped to [0, 1] (measurement noise can land the pipelined total just
    outside the ideal bracket).  Degenerate phases (`min(comp, comm) <= 0`,
    nothing to hide) return 0.0.
    """
    seq = comp_phase_s + comm_phase_s
    ideal = max(comp_phase_s, comm_phase_s)
    if min(comp_phase_s, comm_phase_s) <= 0.0 or seq <= ideal:
        return 0.0
    return float(np.clip((seq - pipelined_total_s) / (seq - ideal), 0.0, 1.0))


def mean_wait_s(patterns: list[StragglerPattern]) -> float:
    """Mean modeled master wait across patterns (seconds)."""
    return float(np.mean([p.wait_s for p in patterns]))
