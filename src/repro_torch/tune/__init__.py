"""Straggler sources (the auto-tuner itself is not ported yet)."""
from .stragglers import (FixedStragglers, NoStragglers, RandomStragglers,
                         StragglerDraw, StragglerSource, TimedSource,
                         as_straggler_source)
from .telemetry import WorkerTimes, scheme_k, scheme_loads

__all__ = ["FixedStragglers", "NoStragglers", "RandomStragglers",
           "StragglerDraw", "StragglerSource", "TimedSource",
           "as_straggler_source", "WorkerTimes", "scheme_k", "scheme_loads"]
