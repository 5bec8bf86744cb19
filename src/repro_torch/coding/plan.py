"""Per-leaf participation planning for the coded aggregation.

The paper groups the flat gradient's coordinates as (v*m + u).  Per
parameter leaf we pick a *grouping dimension* divisible by m (and by n for
the all-to-all schedule).  Leaves with no usable dimension (norm gains,
biases — a negligible byte fraction) are aggregated by a straggler-aware
weighted sum instead.  The model axis has size 1 in the port, so every
dimension is a candidate.

A parameter tree is a flat ``dict`` of tensors (or of anything with a
``.shape``); leaf order is the dict's order everywhere in the codec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one parameter leaf participates in the coded aggregation."""
    coded: bool          # False -> weighted-psum fallback
    group_dim: int = -1  # dimension whose coordinates are grouped by m


def plan_leaf(shape: Sequence[int], m: int, n_split: int = 1) -> LeafPlan:
    """Choose a grouping dimension divisible by m * n_split.  Prefers the
    largest usable dimension (the first among equals)."""
    best, best_size = -1, 0
    for dim, size in enumerate(shape):
        if size % (m * n_split) != 0 or size == 0:
            continue
        if size > best_size:
            best, best_size = dim, size
    if best < 0:
        return LeafPlan(coded=False)
    return LeafPlan(coded=True, group_dim=best)


def plan_tree(tree: Mapping[str, Any], m: int,
              n_split: int = 1) -> dict[str, LeafPlan]:
    """Map ``plan_leaf`` over a dict of tensors / shape carriers."""
    return {k: plan_leaf(tuple(x.shape), m, n_split) for k, x in tree.items()}


def coded_fraction(tree: Mapping[str, Any],
                   plans: Mapping[str, LeafPlan]) -> float:
    """Fraction of gradient elements covered by the code (the rest falls
    back to the weighted sum)."""
    tot = cod = 0
    for k, x in tree.items():
        size = math.prod(x.shape)
        tot += size
        if plans[k].coded:
            cod += size
    return cod / max(tot, 1)
