"""Churn events: how cluster-membership changes enter an elastic run.

Production spot/preemptible fleets change the worker count at runtime.
This module is the fault-injection half of ``repro.elastic``: a
:class:`ChurnSource` is any object producing the :class:`MembershipEvent`
stream for a step (the membership twin of the
:class:`~repro.tune.stragglers.StragglerSource` protocol — one duck type
for every way membership changes enter a run):

- :class:`MembershipTrace` — a scripted, fully deterministic event list
  ("worker 7 leaves at step 6, rejoins at step 24"), the replayable trace
  ``benchmarks/bench_elastic.py`` gates;
- :class:`PoissonChurn` — a seeded sampler where each up worker leaves
  with a per-step hazard and each down worker rejoins with another, the
  spot-fleet stand-in for soak tests.

Event kinds:

- ``"leave"`` — graceful departure (scale-down notice): the worker is
  gone immediately and permanently until a ``"join"``;
- ``"preempt"`` — abrupt departure (spot reclaim): semantically identical
  to ``"leave"`` for the tracker, kept distinct so policies/telemetry can
  count reclaims separately;
- ``"join"`` — a worker (re)joins; an index ``>= n`` announces a
  brand-new worker and is the :class:`~repro.elastic.ElasticTrainer`'s
  scale-up trigger.

On a real cluster the source would wrap the scheduler's node-event feed;
the protocol is the seam where that feed plugs in.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Protocol, Sequence, runtime_checkable

import numpy as np

#: The recognised event kinds, in escalation order.
EVENT_KINDS = ("join", "leave", "preempt")


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One membership change: a worker joins, leaves, or is preempted."""

    step: int     # training step at which the event fires
    kind: str     # "join" | "leave" | "preempt"
    worker: int   # worker index (a join with worker >= n grows the cluster)

    def __post_init__(self):
        """Validate the event kind and worker index eagerly."""
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown membership event kind {self.kind!r}; "
                f"expected one of {EVENT_KINDS}")
        if self.worker < 0:
            raise ValueError(f"worker index must be >= 0, got {self.worker}")


@runtime_checkable
class ChurnSource(Protocol):
    """Structural protocol every membership-change process implements."""

    def events(self, step: int) -> tuple[MembershipEvent, ...]:
        """The membership events firing at ``step`` (empty most steps)."""
        ...


class NoChurn:
    """A cluster whose membership never changes (the default source)."""

    def events(self, step: int) -> tuple[MembershipEvent, ...]:
        """Always empty."""
        return ()


class MembershipTrace:
    """A scripted, deterministic churn trace.

    Accepts :class:`MembershipEvent` instances or bare
    ``(step, kind, worker)`` tuples; events are indexed by step so
    :meth:`events` is O(1) per call.

    >>> trace = MembershipTrace([(6, "leave", 7), (24, "join", 7)])
    >>> [e.kind for e in trace.events(6)]
    ['leave']
    >>> trace.events(7)
    ()
    """

    def __init__(self, events: Iterable[MembershipEvent | tuple]):
        """``events``: any mix of events and ``(step, kind, worker)``."""
        self._by_step: dict[int, list[MembershipEvent]] = {}
        for e in events:
            ev = e if isinstance(e, MembershipEvent) else MembershipEvent(*e)
            self._by_step.setdefault(ev.step, []).append(ev)

    @property
    def all_events(self) -> tuple[MembershipEvent, ...]:
        """Every scripted event, ordered by step."""
        out: list[MembershipEvent] = []
        for step in sorted(self._by_step):
            out.extend(self._by_step[step])
        return tuple(out)

    def events(self, step: int) -> tuple[MembershipEvent, ...]:
        """The events scripted for ``step``."""
        return tuple(self._by_step.get(step, ()))


class PoissonChurn:
    """Seeded random churn: per-step leave/rejoin hazards per worker.

    Each up worker leaves (as a ``"preempt"``) with probability
    ``1 - exp(-leave_rate)`` per step; each down worker rejoins with
    probability ``1 - exp(-join_rate)`` — i.e. independent discretised
    Poisson processes, so expected up-time between reclaims is
    ``1 / leave_rate`` steps.  Fully deterministic given ``seed``: the
    event stream depends only on the seed and the steps queried (steps
    must be queried in nondecreasing order, as in a training loop).
    """

    def __init__(self, n: int, leave_rate: float, join_rate: float,
                 seed: int = 0, max_down: int | None = None):
        """``n`` workers; ``max_down`` caps simultaneous departures
        (default ``n - 1`` — the cluster never empties)."""
        if n < 1:
            raise ValueError(f"need n >= 1 workers, got {n}")
        if leave_rate < 0 or join_rate < 0:
            raise ValueError("leave_rate and join_rate must be >= 0")
        self.n = n
        self.p_leave = 1.0 - float(np.exp(-leave_rate))
        self.p_join = 1.0 - float(np.exp(-join_rate))
        self.max_down = n - 1 if max_down is None else int(max_down)
        self._rng = np.random.default_rng(seed)
        self._down: set[int] = set()
        self._last_step = -1

    def events(self, step: int) -> tuple[MembershipEvent, ...]:
        """Sample the events for ``step`` (call with nondecreasing steps)."""
        if step <= self._last_step:
            return ()   # idempotent re-query of an already-sampled step
        self._last_step = step
        out: list[MembershipEvent] = []
        for w in range(self.n):
            if w in self._down:
                if self._rng.random() < self.p_join:
                    self._down.discard(w)
                    out.append(MembershipEvent(step, "join", w))
            elif (len(self._down) < self.max_down
                    and self._rng.random() < self.p_leave):
                self._down.add(w)
                out.append(MembershipEvent(step, "preempt", w))
        return tuple(out)


def as_churn_source(obj) -> ChurnSource:
    """Coerce ``None`` / an event list / a source into a ChurnSource.

    ``None`` -> :class:`NoChurn`; an object with an ``events`` method is
    returned as-is; a sequence of events/tuples becomes a
    :class:`MembershipTrace`.
    """
    if obj is None:
        return NoChurn()
    if hasattr(obj, "events") and callable(obj.events):
        return obj
    if isinstance(obj, Sequence):
        return MembershipTrace(obj)
    raise TypeError(
        f"cannot interpret {type(obj).__name__!r} as a ChurnSource: need "
        f"None, a sequence of (step, kind, worker) events, or an object "
        f"with events(step)")
