"""Benchmark helpers, numpy only.  So far only the Section-VI straggler
injection (``straggler``, a copy of the reference's ``repro.bench.straggler``)
that the auto-tuner's planners draw from; the rest of the reference's harness
(results, timing, environment, registry, gate) is not ported yet."""
from .straggler import (StragglerPattern, draw_patterns,
                        draw_patterns_hetero, draw_patterns_overlapped,
                        mean_wait_s, overlap_fraction)

__all__ = [
    "StragglerPattern",
    "draw_patterns",
    "draw_patterns_hetero",
    "draw_patterns_overlapped",
    "mean_wait_s",
    "overlap_fraction",
]
