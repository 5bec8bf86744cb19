"""Leaf-layout <-> canonical-shape conversions.

The backends contract canonical tensors (``(d, V, m[, R])`` encode,
``(n, V[, R])`` decode); parameter leaves are arbitrary-rank with a planned
grouping dimension.  These helpers move the grouping dim first, split it into
(V, m) groups, and flatten any trailing dims into the single R axis the
kernels run over.  ``reshape`` copies only when the moved view is strided, so
what reaches a kernel is contiguous.
"""
from __future__ import annotations

import math

import torch

from .plan import LeafPlan


def leaf_to_groups(g: torch.Tensor, plan: LeafPlan, m: int) -> torch.Tensor:
    """(..., Dg, ...) -> (V, m, *rest) with the grouping dim split first."""
    x = torch.movedim(g, plan.group_dim, 0)
    Dg = x.shape[0]
    return x.reshape(Dg // m, m, *x.shape[1:])


def groups_to_leaf(decoded: torch.Tensor, plan: LeafPlan) -> torch.Tensor:
    """(V, m, *rest) -> original leaf layout (inverse of ``leaf_to_groups``)."""
    V, m = decoded.shape[:2]
    x = decoded.reshape(V * m, *decoded.shape[2:])
    return torch.movedim(x, 0, plan.group_dim)


def flatten_rest(x: torch.Tensor, lead: int) -> torch.Tensor:
    """Collapse all dims after the first ``lead`` into one trailing R axis
    (no-op when there are none)."""
    rest = x.shape[lead:]
    if not rest:
        return x
    return x.reshape(*x.shape[:lead], math.prod(rest))


def unflatten_rest(x: torch.Tensor, lead: int,
                   rest: tuple[int, ...]) -> torch.Tensor:
    """Inverse of ``flatten_rest``."""
    if not rest:
        return x
    return x.reshape(*x.shape[:lead], *rest)
