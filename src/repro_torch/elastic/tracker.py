"""`MembershipTracker`: the cluster-membership state machine.

The tracker is the single source of truth for which workers currently
exist, fed from two directions:

- **explicit events** (:meth:`MembershipTracker.apply`) — join / leave /
  preempt from a :class:`~repro.elastic.events.ChurnSource` (scheduler
  notices, scripted traces, Poisson churn);
- **implicit escalation** (:meth:`MembershipTracker.observe`) — a worker
  that keeps missing heartbeats (keeps appearing in the straggler set)
  escalates ``active -> suspected -> departed`` on configurable
  thresholds, so a silently-dead worker is eventually evicted even when
  no scheduler event ever arrives.

Escalation thresholds: ``suspect_after`` consecutive misses mark a worker
*suspected*; ``evict_after`` further consecutive misses evict it
(*departed*).  ``backoff`` multiplies the eviction threshold after each
previous eviction of the same worker — ``backoff > 1`` gives flappy
workers longer grace periods before re-evicting, ``< 1`` evicts repeat
offenders faster.  Any responsive step fully resets the counters.

:class:`MembershipSource` adapts the tracker onto the
:class:`~repro.tune.stragglers.StragglerSource` protocol: it wraps an
inner source (heartbeat feed / injector), feeds every draw's straggler
set through :meth:`~MembershipTracker.observe`, and merges the departed
set into the draw — a departed worker is a *forced straggler* every step
until it rejoins (degradation rung 1).
"""
from __future__ import annotations

import dataclasses

from ..tune.stragglers import StragglerDraw, as_straggler_source

from .events import MembershipEvent

#: Worker lifecycle states, in escalation order.
ACTIVE, SUSPECTED, DEPARTED = "active", "suspected", "departed"


@dataclasses.dataclass
class _WorkerState:
    """Per-worker lifecycle bookkeeping."""

    state: str = ACTIVE
    misses: int = 0           # consecutive missed heartbeats
    evictions: int = 0        # times this worker has been evicted before
    departed_since: int = -1  # step the current departure started (-1: none)


class MembershipTracker:
    """Worker lifecycle state machine: active -> suspected -> departed.

    ``n`` is the current cluster size; worker indices are positional in
    the current cluster (a resize renumbers, see :meth:`resize`).
    """

    def __init__(self, n: int, suspect_after: int = 2, evict_after: int = 3,
                 backoff: float = 1.0):
        """``suspect_after``/``evict_after``: consecutive-miss thresholds;
        ``backoff``: eviction-threshold multiplier per prior eviction."""
        if n < 1:
            raise ValueError(f"need n >= 1 workers, got {n}")
        if suspect_after < 1 or evict_after < 1:
            raise ValueError("suspect_after and evict_after must be >= 1")
        if backoff <= 0:
            raise ValueError(f"backoff must be > 0, got {backoff}")
        self.n = int(n)
        self.suspect_after = int(suspect_after)
        self.evict_after = int(evict_after)
        self.backoff = float(backoff)
        self._workers = {i: _WorkerState() for i in range(self.n)}
        #: join events naming workers >= n (scale-up requests), deduplicated
        self.pending_joins: set[int] = set()
        #: chronological log of (step, worker, transition) for docs/benches
        self.log: list[tuple[int, int, str]] = []

    # ------------------------------------------------------------ queries
    @property
    def departed(self) -> tuple[int, ...]:
        """Sorted indices of departed workers (< n)."""
        return tuple(sorted(i for i, w in self._workers.items()
                            if w.state == DEPARTED))

    @property
    def suspected(self) -> tuple[int, ...]:
        """Sorted indices of suspected (not yet evicted) workers."""
        return tuple(sorted(i for i, w in self._workers.items()
                            if w.state == SUSPECTED))

    @property
    def active(self) -> tuple[int, ...]:
        """Sorted indices of fully responsive workers."""
        return tuple(sorted(i for i, w in self._workers.items()
                            if w.state == ACTIVE))

    @property
    def n_alive(self) -> int:
        """Workers not departed (active + suspected)."""
        return self.n - len(self.departed)

    def departed_for(self, worker: int, step: int) -> int:
        """Steps worker ``worker`` has been departed as of ``step`` (0 if
        not departed)."""
        w = self._workers.get(worker)
        if w is None or w.state != DEPARTED or w.departed_since < 0:
            return 0
        return max(0, step - w.departed_since)

    def state_of(self, worker: int) -> str:
        """The lifecycle state of ``worker`` ("active"/"suspected"/
        "departed")."""
        return self._workers[worker].state

    # ------------------------------------------------------- event intake
    def apply(self, event: MembershipEvent) -> None:
        """Ingest one explicit churn event.

        A join for an unknown index (``>= n``) is recorded in
        ``pending_joins`` — the resize trigger the
        :class:`~repro.elastic.ElasticTrainer` polls.
        """
        w = event.worker
        if event.kind == "join":
            if w >= self.n:
                self.pending_joins.add(w)
                self.log.append((event.step, w, "pending-join"))
                return
            st = self._workers[w]
            if st.state != ACTIVE:
                self.log.append((event.step, w, f"{st.state}->active"))
            st.state = ACTIVE
            st.misses = 0
            st.departed_since = -1
        else:  # leave / preempt: immediate departure
            if w >= self.n:
                return  # already outside the cluster
            st = self._workers[w]
            if st.state != DEPARTED:
                st.evictions += 0  # explicit departures are not evictions
                st.departed_since = event.step
                self.log.append((event.step, w, f"{st.state}->departed"
                                 f" ({event.kind})"))
            st.state = DEPARTED

    # -------------------------------------------- heartbeat-miss escalation
    def _evict_threshold(self, st: _WorkerState) -> float:
        """Eviction threshold for a worker, backoff-scaled per prior
        eviction."""
        return self.evict_after * (self.backoff ** st.evictions)

    def observe(self, stragglers, step: int) -> None:
        """Ingest one step's straggler set as heartbeat evidence.

        Workers in ``stragglers`` accrue a miss and may escalate; workers
        outside it (and inside the cluster) reset to active unless
        explicitly departed.
        """
        missed = {int(i) for i in stragglers if 0 <= int(i) < self.n}
        for i, st in self._workers.items():
            if st.state == DEPARTED:
                continue  # only an explicit join resurrects a departure
            if i in missed:
                st.misses += 1
                if (st.state == SUSPECTED
                        and st.misses >= self.suspect_after
                        + self._evict_threshold(st)):
                    st.state = DEPARTED
                    st.evictions += 1
                    st.departed_since = step
                    self.log.append((step, i, "suspected->departed (evict)"))
                elif st.state == ACTIVE and st.misses >= self.suspect_after:
                    st.state = SUSPECTED
                    self.log.append((step, i, "active->suspected"))
            else:
                if st.state == SUSPECTED:
                    self.log.append((step, i, "suspected->active"))
                st.state = ACTIVE
                st.misses = 0

    def reactivate_all(self, step: int = -1) -> None:
        """Mark every tracked position active (fresh misses, no departure).

        Called after a cluster **repack**: a resize renumbers the *alive*
        physical workers into ``0..n-1``, so any retained departed/
        suspected state would describe a position now held by a healthy
        worker.  Eviction counts survive — flap history is about the
        position's churn exposure, which repacking does not erase.
        """
        for i, st in self._workers.items():
            if st.state != ACTIVE:
                self.log.append((step, i, f"{st.state}->active (repack)"))
            st.state = ACTIVE
            st.misses = 0
            st.departed_since = -1

    # -------------------------------------------------------------- resize
    def resize(self, new_n: int, step: int = -1) -> None:
        """Renumber the cluster to ``new_n`` positional workers.

        Shrinking drops the trailing indices' state; growing adds fresh
        active workers.  Pending joins absorbed by the new size are
        cleared.  Eviction counts (the backoff memory) survive for
        retained indices.
        """
        if new_n < 1:
            raise ValueError(f"need new_n >= 1, got {new_n}")
        if new_n == self.n:
            return
        if new_n < self.n:
            for i in range(new_n, self.n):
                self._workers.pop(i, None)
        else:
            for i in range(self.n, new_n):
                self._workers[i] = _WorkerState()
        self.n = new_n
        self.pending_joins = {w for w in self.pending_joins if w >= new_n}
        self.log.append((step, -1, f"resize->{new_n}"))


class MembershipSource:
    """`StragglerSource` adapter: inner draws + membership escalation.

    Wraps an inner straggler source (heartbeat feed, injector, fixed set):
    every draw's straggler set feeds :meth:`MembershipTracker.observe` (so
    persistently missing workers escalate to departed), and the tracker's
    departed set is merged into the returned draw — a departed worker is a
    forced straggler until it rejoins.  ``times`` pass through unchanged;
    out-of-cluster indices are dropped via
    :meth:`~repro.tune.stragglers.StragglerDraw.restrict`.
    """

    def __init__(self, tracker: MembershipTracker, inner=None):
        """``inner`` is coerced via
        :func:`~repro.tune.stragglers.as_straggler_source` (None = no
        genuine stragglers, membership-only)."""
        self.tracker = tracker
        self.inner = as_straggler_source(inner)

    @property
    def provides_times(self) -> bool:
        """Mirrors the wrapped source (the tracker adds no timings)."""
        return self.inner.provides_times

    def draw(self, step: int, code) -> StragglerDraw:
        """Inner draw -> observe -> merge departed -> restrict to n."""
        d = self.inner.draw(step, code).restrict(self.tracker.n)
        self.tracker.observe(d.stragglers, step)
        merged = sorted(set(d.stragglers)
                        | set(self.tracker.departed))
        return StragglerDraw(
            stragglers=tuple(merged), times=d.times,
            wait_s=d.wait_s).restrict(min(self.tracker.n, code.n))
