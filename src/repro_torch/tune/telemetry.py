"""Per-worker step timings and the scheme accessors (the parts of the
reference's telemetry module that the straggler sources and the trainer's
scheme signature need; the step records, the log and the
shifted-exponential samplers wait for the auto-tuner's port)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkerTimes:
    """One step's per-worker durations (seconds), compute and comm apart."""

    compute_s: np.ndarray  # (n,) time to finish the worker's assigned subsets
    comm_s: np.ndarray     # (n,) time to transmit the worker's l/m encoding

    @property
    def total_s(self) -> np.ndarray:
        """(n,) per-worker finish times: compute + communication."""
        return self.compute_s + self.comm_s

    def order_stat(self, n_drop: int) -> tuple[tuple[int, ...], float]:
        """Drop the ``n_drop`` slowest workers; return (stragglers, wait).

        The wait is the ``(n - n_drop)``-th order statistic of the totals.
        Missing per-worker times (NaN) are treated as ``+inf``: such a
        worker is always among the dropped, and the wait stays finite as
        long as the drop budget covers the missing workers.
        """
        t = np.where(np.isnan(self.total_s), np.inf, self.total_s)
        n = t.shape[0]
        order = np.argsort(t)
        slow = tuple(int(i) for i in order[n - n_drop:]) if n_drop else ()
        return slow, float(t[order[n - n_drop - 1]])


def scheme_loads(code) -> tuple[int, ...]:
    """Per-worker subset loads of any ``GradCode``-duck scheme object
    (uniform fallback ``(d,) * n`` for minimal ducks without ``loads``)."""
    return tuple(getattr(code, "loads", (code.d,) * code.n))


def scheme_k(code) -> int:
    """Subset count ``k`` of any ``GradCode``-duck scheme object (``n``
    for ducks without ``num_subsets`` — the uniform family's value)."""
    return int(getattr(code, "num_subsets", code.n))
