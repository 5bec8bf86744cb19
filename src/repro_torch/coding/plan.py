"""Per-leaf participation planning for the coded aggregation.

The paper groups the flat gradient's coordinates as (v*m + u).  Per
parameter leaf we pick a *grouping dimension* divisible by m (and by n for
the all-to-all schedule).  Leaves with no usable dimension (norm gains,
biases — a negligible byte fraction) are aggregated by a straggler-aware
weighted sum instead.

A model's leaves also skip the dims that the reference's tensor-parallel
layout puts on its model axis (``param_specs``).  The port runs no model
axis, but the reference skips those dims at any model-axis size, the size
1 included; taking the same rule makes both packages pair the same
coordinates, so a partial decode's least-squares estimate is the same on
both sides (an exact decode does not depend on the grouping).

A parameter tree is a flat ``dict`` of tensors (or of anything with a
``.shape``) under ``"a/b/c"`` keys; leaf order is the dict's order
everywhere in the codec.
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


def plan_leaf(shape: Sequence[int], m: int, n_split: int = 1,
              spec: Sequence[Any] | None = None) -> LeafPlan:
    """Choose a grouping dimension: model-replicated (``spec`` entry None,
    every dim when ``spec`` is None) and divisible by m * n_split.  Prefers
    the largest usable dimension (the first among equals)."""
    best, best_size = -1, 0
    for dim, size in enumerate(shape):
        entry = None if spec is None or dim >= len(spec) else spec[dim]
        if entry is not None:
            continue  # on the reference's model axis — do not regroup
        if size % (m * n_split) != 0 or size == 0:
            continue
        if size > best_size:
            best, best_size = dim, size
    if best < 0:
        return LeafPlan(coded=False)
    return LeafPlan(coded=True, group_dim=best)


def plan_tree(tree: Mapping[str, Any], m: int, n_split: int = 1,
              specs: Mapping[str, Sequence[Any]] | None = None
              ) -> dict[str, LeafPlan]:
    """Map ``plan_leaf`` over a dict of tensors / shape carriers (and the
    ``param_specs`` of the same keys, when given)."""
    return {k: plan_leaf(tuple(x.shape), m, n_split,
                         None if specs is None else specs[k])
            for k, x in tree.items()}


# ------------------------------------------- the reference's model-axis layout
# leaves that live under a stacked-layer container get one leading stack dim
_STACKS = ("layers", "pairs", "mamba", "enc_layers", "dec_layers")


def _rule(names: list[str], shape: tuple[int, ...], ms: int, ax: str):
    """PartitionSpec entries for the *unstacked* trailing dims."""
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    nd = len(shape)

    def ok(d):
        return shape[d] % ms == 0 and shape[d] >= ms

    def spec(*entries):
        return list(entries)

    if nd <= 1:
        # gains, biases (1-d), scalars: replicate (negligible bytes)
        return spec(*([None] * nd))
    if name == "embed":
        return spec(ax if ok(0) else None, None)
    if name == "unembed":
        return spec(None, ax if ok(1) else None)
    if name in ("enc_pos", "dec_pos"):
        return spec(None, None)
    if name == "beta":
        return spec(ax if ok(0) else None)
    if parent in ("attn", "xattn") or (name in ("wq", "wk", "wv") and nd == 3):
        if name == "wq":
            return spec(None, ax if ok(1) else None, None)
        if name in ("wk", "wv"):
            return spec(None, ax if ok(1) else None, None)
        if name == "wo":
            return spec(ax if ok(0) else None, None, None)
        if name in ("bq", "bk", "bv"):
            return spec(ax if ok(0) else None, None)
    if parent == "moe":
        if name in ("w_gate", "w_up"):   # (E, D, F)
            if ok(0):
                return spec(ax, None, None)
            return spec(None, None, ax if ok(2) else None)
        if name == "w_down":             # (E, F, D)
            if ok(0):
                return spec(ax, None, None)
            return spec(None, ax if ok(1) else None, None)
    if name == "router":
        return spec(None, None)
    if name in ("w_gate", "w_up"):       # (D, F) mlp
        return spec(None, ax if ok(1) else None)
    if name == "w_down":                 # (F, D)
        return spec(ax if ok(0) else None, None)
    # xlstm inner projections (2-d): shard the output column
    if name in ("wz", "wi", "wf", "wo", "wq", "wk", "wv", "w_up2") and nd == 2:
        return spec(None, ax if ok(1) else None)
    if name == "r":                      # (4, H, hd, hd) recurrent block-diag
        return spec(None, None, None, None)
    if name == "in_proj":                # (D, X)
        return spec(None, ax if ok(1) else None)
    if name == "out_proj":               # (Di, D)
        return spec(ax if ok(0) else None, None)
    if name in ("conv_w", "conv_b"):
        return spec(*([None] * nd))
    # fallback: shard the largest divisible dim
    order = sorted(range(nd), key=lambda d: -shape[d])
    for d in order:
        if ok(d):
            e = [None] * nd
            e[d] = ax
            return spec(*e)
    return spec(*([None] * nd))


def param_specs(tree: Mapping[str, Any]) -> dict[str, tuple]:
    """The reference's tensor-parallel layout of a model's parameters on a
    model axis of size 1 (``repro.train.sharding.param_specs(tree, 1)``):
    per ``"a/b/c"`` key, one entry a dim, ``"model"`` where the leaf is
    sharded over the model axis, else None.  Leaf names decide, as in the
    reference, so only a model's own tree gives a meaningful layout."""
    out = {}
    for key, x in tree.items():
        names = key.split("/")
        shape = tuple(x.shape)
        stacked = any(n in _STACKS for n in names)
        body = shape[1:] if stacked else shape
        entries = _rule(names, body, 1, "model")
        out[key] = tuple([None] + entries if stacked else entries)
    return out


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
