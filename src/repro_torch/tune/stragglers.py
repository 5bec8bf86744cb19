"""`StragglerSource`: one protocol for every way stragglers enter a run.

The Trainer historically took three overlapping knobs — ``straggler_mode``
("none"/"random"/"fixed"), ``fixed_stragglers`` and ``injector`` — and the
serving engine's hedging loop would have needed a fourth spelling.  This
module collapses them into a single duck type shared by
``Trainer(straggler_source=...)`` and ``CodedServer(straggler_source=...)``:

    source.draw(step, code) -> StragglerDraw(stragglers, times)

``stragglers`` is the straggler index set for the step; ``times`` is the
optional per-worker :class:`~repro_torch.tune.telemetry.WorkerTimes` behind it
(present iff ``source.provides_times`` — the autotuner and the serving
latency model both need real timings, not just index sets).

Adapters:

- :class:`NoStragglers` — every worker responds (the default).
- :class:`FixedStragglers` — a constant index set.
- :class:`RandomStragglers` — uniform draws of up to ``code.s`` workers
  (the legacy ``straggler_mode="random"`` process, same RNG discipline).
- :class:`TimedSource` — wraps an injector callable
  ``(step, code) -> WorkerTimes`` (e.g.
  :class:`~repro_torch.tune.telemetry.ShiftedExpSampler`); the slowest ``s``
  workers of each draw are the stragglers.

:func:`as_straggler_source` coerces ``None`` / a bare injector callable /
an existing source, so callers accept all three without ceremony.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from .telemetry import WorkerTimes


@dataclasses.dataclass(frozen=True)
class StragglerDraw:
    """One step's straggler outcome: the index set + optional timings.

    ``wait_s`` is the modeled master wait (the ``(n - |stragglers|)``-th
    order statistic of the totals) when timings exist, else 0.0 — serving
    composes it with the measured step wall-clock for hedged-latency
    accounting.
    """

    stragglers: tuple[int, ...] = ()
    times: WorkerTimes | None = None
    wait_s: float = 0.0

    def restrict(self, n: int) -> "StragglerDraw":
        """A copy with straggler indices outside ``0..n-1`` dropped.

        The elastic-membership case: after a resize a source (or a stale
        churn trace) may still name workers that no longer exist; the
        trainer restricts every draw to the active code's ``n`` so those
        indices cannot corrupt the decode-weight solve.  Returns ``self``
        when nothing is out of range (the common case allocates nothing).
        """
        if all(0 <= i < n for i in self.stragglers):
            return self
        kept = tuple(i for i in self.stragglers if 0 <= i < n)
        return dataclasses.replace(self, stragglers=kept)


@runtime_checkable
class StragglerSource(Protocol):
    """Structural protocol every straggler process implements."""

    #: True when ``draw(...).times`` carries real per-worker timings —
    #: required by the autotuner's MLE and the serving latency model.
    provides_times: bool

    def draw(self, step: int, code) -> StragglerDraw:
        """The straggler outcome for one step under scheme ``code``."""
        ...


class NoStragglers:
    """Every worker responds every step (the default source)."""

    provides_times = False

    def draw(self, step: int, code) -> StragglerDraw:
        """Empty straggler set, no timings."""
        return StragglerDraw()


class FixedStragglers:
    """A constant straggler index set (the legacy ``straggler_mode="fixed"``)."""

    provides_times = False

    def __init__(self, indices):
        """``indices``: worker indices that straggle every step."""
        self.indices = tuple(int(i) for i in indices)

    def draw(self, step: int, code) -> StragglerDraw:
        """The fixed set, independent of step and scheme."""
        return StragglerDraw(stragglers=self.indices)


class RandomStragglers:
    """Uniform random straggler sets of size 0..code.s per step.

    Reproduces the legacy ``straggler_mode="random"`` process exactly: one
    ``numpy`` Generator seeded at construction draws first the set size
    (``integers(0, s + 1)``) then the worker subset without replacement.
    """

    provides_times = False

    def __init__(self, seed: int = 0):
        """``seed`` seeds the private ``numpy`` Generator."""
        self._rng = np.random.default_rng(seed)

    def draw(self, step: int, code) -> StragglerDraw:
        """Up to ``code.s`` uniformly chosen stragglers."""
        if code.s == 0:
            return StragglerDraw()
        size = int(self._rng.integers(0, code.s + 1))
        idx = self._rng.choice(code.n, size=size, replace=False)
        return StragglerDraw(stragglers=tuple(int(i) for i in idx))


class TimedSource:
    """Straggler source backed by per-worker timings (injector/heartbeats).

    Wraps a callable ``(step, code) -> WorkerTimes`` — a
    :class:`~repro_torch.tune.telemetry.ShiftedExpSampler`, a
    :class:`~repro_torch.tune.telemetry.DriftingSampler`, or a real cluster
    heartbeat feed.  Each draw drops the slowest ``n_drop`` workers
    (default: the scheme's design ``s``) and reports the order-statistic
    wait, which is what the autotuner's telemetry and the serving hedging
    loop both consume.
    """

    provides_times = True

    def __init__(self, injector: Callable[[int, object], WorkerTimes],
                 n_drop: int | None = None):
        """``injector``: the timing process; ``n_drop`` overrides ``code.s``."""
        self.injector = injector
        self.n_drop = n_drop

    def draw(self, step: int, code) -> StragglerDraw:
        """Draw timings; stragglers = the slowest ``n_drop`` workers."""
        times = self.injector(step, code)
        n_drop = code.s if self.n_drop is None else self.n_drop
        slow, wait = times.order_stat(n_drop)
        return StragglerDraw(stragglers=slow, times=times, wait_s=wait)


def as_straggler_source(obj) -> StragglerSource:
    """Coerce ``None`` / injector callable / source into a StragglerSource.

    ``None`` -> :class:`NoStragglers`; an object with a ``draw`` method is
    returned as-is; any other callable is assumed to be an injector
    ``(step, code) -> WorkerTimes`` and wrapped in :class:`TimedSource`.
    """
    if obj is None:
        return NoStragglers()
    if hasattr(obj, "draw") and hasattr(obj, "provides_times"):
        return obj
    if callable(obj):
        return TimedSource(obj)
    raise TypeError(
        f"cannot interpret {type(obj).__name__!r} as a StragglerSource: "
        f"need None, a (step, code) -> WorkerTimes callable, or an object "
        f"with draw()/provides_times")
