"""Static packing of coded-leaf encodings into bucketed flat wire buffers.

The per-leaf decode path issues one collective (plus one skinny contraction)
*per coded parameter leaf*; with dozens of leaves the per-collective latency
dominates, as the paper's shifted-exponential T_comm model (Sec. VI)
predicts.  This module computes, once at step-build time, a ``PackPlan``
that lays every coded leaf's flattened ``(V, *rest)`` encoding into one (or
a few) flat wire buffers, so each train step issues O(1) collectives per
*bucket* and runs one large decode contraction over the packed buffer.

Bucketing: leaves are grouped by (wire dtype, model-sharding pattern).  The
model axis has size 1 in the port, so the pattern is always ``()`` and every
coded leaf lands in one bucket per wire dtype; the key keeps the reference's
shape so slot tables compare field by field.

Layout invariants:
  - slot offsets are ``align`` (default 128) element-aligned;
  - each bucket's padded length is divisible by lcm(align, n), so the a2a
    schedule can split it into n equal chunks without per-leaf divisibility
    constraints;
  - padding elements are zeros on the wire and are never read back — the
    unpack phase uses static slices from the slot table.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Mapping, Sequence

import torch

from .layout import groups_to_leaf, leaf_to_groups
from .plan import LeafPlan
from .wire import dtype_name

# element alignment of slot offsets and bucket lengths
WIRE_ALIGN = 128


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def enc_shape(shape: Sequence[int], plan: LeafPlan, m: int) -> tuple[int, ...]:
    """The ``(V, *rest)`` encoding shape of a coded leaf (the shape
    ``encode_leaf`` produces: grouping dim moved first and split by m)."""
    assert plan.coded
    k = plan.group_dim
    moved = (shape[k],) + tuple(shape[:k]) + tuple(shape[k + 1:])
    return (moved[0] // m,) + moved[1:]


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one coded leaf's flattened encoding lives in its bucket."""
    leaf_index: int            # position in the parameter dict's order
    offset: int                # start element in the bucket's flat buffer
    size: int                  # unpadded elements = prod(enc_shape)
    enc_shape: tuple[int, ...]  # (V, *rest)
    plan: LeafPlan


@dataclasses.dataclass(frozen=True)
class WireBucket:
    """One flat wire buffer: a slot table plus its padded length."""
    key: tuple                 # (wire dtype name, model-sharding pattern)
    slots: tuple[LeafSlot, ...]
    size: int                  # padded length: align-multiple and n-divisible
    unpadded: int              # sum of slot sizes

    @property
    def padding(self) -> int:
        """Zero elements added for alignment and the n-divisible tail."""
        return self.size - self.unpadded

    @functools.lru_cache(maxsize=None)
    def worker_chunk_slots(self, n: int) -> tuple[tuple, ...]:
        """Ragged per-worker view of the a2a chunking of this bucket.

        The a2a schedule splits the ``size``-element buffer into ``n`` equal
        chunks and worker ``p`` decodes chunk ``p`` — but the *slot*
        boundaries do not align with the chunk boundaries, so each worker
        covers a ragged set of (possibly partial) leaf segments.  Returns,
        per worker, a tuple of ``(leaf_index, elem_lo, elem_hi)`` triples in
        that leaf's flattened-encoding coordinates.  The union over workers
        tiles every slot exactly once.
        """
        assert self.size % n == 0, f"bucket size {self.size} not n={n}-divisible"
        chunk = self.size // n
        out = []
        for p in range(n):
            lo_p, hi_p = p * chunk, (p + 1) * chunk
            segs = []
            for s in self.slots:
                lo = max(s.offset, lo_p)
                hi = min(s.offset + s.size, hi_p)
                if lo < hi:
                    segs.append((s.leaf_index, lo - s.offset, hi - s.offset))
            out.append(tuple(segs))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """Static wire layout for every coded leaf of a parameter dict."""
    buckets: tuple[WireBucket, ...]
    align: int
    n: int                     # data-parallel degree (a2a chunk divisor)
    m: int                     # the code's group size (encoding = l/m elems)
    wire_dtype: str

    @property
    def padded_elems(self) -> int:
        """Total elements actually put on the wire per worker."""
        return sum(b.size for b in self.buckets)

    @property
    def unpadded_elems(self) -> int:
        """Total payload elements (sum of coded-leaf encoding sizes)."""
        return sum(b.unpadded for b in self.buckets)

    @property
    def num_coded_leaves(self) -> int:
        """Total coded leaves across every bucket's slot table."""
        return sum(len(b.slots) for b in self.buckets)

    def recv_elems_per_worker(self, schedule) -> float:
        """Padding-exact wire cost under ``schedule``'s own model: the
        schedule takes the pre-encoding gradient length l and divides by m
        internally, so feeding it l = padded_elems * m yields exactly what
        the padded buffers transmit."""
        return schedule.recv_elems_per_worker(
            float(self.padded_elems * self.m), self.n, self.m)


def make_pack_plan(tree: Mapping[str, Any], plans: Mapping[str, LeafPlan], *,
                   m: int, n: int, align: int = WIRE_ALIGN,
                   wire_dtype="float32") -> PackPlan:
    """Compute the static wire layout from the leaf plans.

    tree:  parameter dict (tensors or anything with ``.shape``);
    plans: matching ``LeafPlan`` dict (``plan_tree`` output).
    """
    name = dtype_name(wire_dtype)
    groups: dict[tuple, list[tuple[int, tuple[int, ...], LeafPlan]]] = {}
    for i, (k, x) in enumerate(tree.items()):
        pl = plans[k]
        if pl is None or not pl.coded:
            continue
        es = enc_shape(tuple(x.shape), pl, m)
        groups.setdefault((name, ()), []).append((i, es, pl))

    chunk = math.lcm(align, n)   # bucket length: aligned AND n-divisible
    buckets = []
    for key in sorted(groups):
        off = 0
        slots = []
        for i, es, pl in groups[key]:
            off = _round_up(off, align)
            size = math.prod(es)
            slots.append(LeafSlot(leaf_index=i, offset=off, size=size,
                                  enc_shape=es, plan=pl))
            off += size
        buckets.append(WireBucket(
            key=key, slots=tuple(slots),
            size=_round_up(off, chunk),
            unpadded=sum(s.size for s in slots)))
    return PackPlan(buckets=tuple(buckets), align=align, n=n, m=m,
                    wire_dtype=name)


# ------------------------------------------------------------ step phases
def _gap(n: int, like: torch.Tensor, dtype, *trail: int) -> torch.Tensor:
    return torch.zeros((n, *trail), dtype=dtype, device=like.device)


def pack_bucket(flat_leaves: Sequence[torch.Tensor], bucket: WireBucket,
                dtype: torch.dtype) -> torch.Tensor:
    """Concatenate the bucket's slot encodings (flattened, already in the
    wire dtype after ``Codec.to_wire``) with exact-zero padding at the
    alignment gaps and the tail."""
    like = flat_leaves[bucket.slots[0].leaf_index]
    parts: list[torch.Tensor] = []
    pos = 0
    for s in bucket.slots:
        if s.offset > pos:
            parts.append(_gap(s.offset - pos, like, dtype))
        parts.append(flat_leaves[s.leaf_index].reshape(-1).to(dtype))
        pos = s.offset + s.size
    if bucket.size > pos:
        parts.append(_gap(bucket.size - pos, like, dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def psum_fallback(flat_leaves: Sequence[torch.Tensor], flat_plans,
                  comm) -> dict[int, torch.Tensor]:
    """Aggregate the non-coded leaves through ONE concatenated all-reduce
    (instead of one per leaf) and slice the sums back out.

    ``flat_leaves[i]`` carries the leading worker axis: ``(n, *leaf shape)``.
    Returns {leaf_index: summed leaf}; empty when every leaf is coded."""
    small_ix = [i for i, pl in enumerate(flat_plans)
                if pl is None or not pl.coded]
    if not small_ix:
        return {}
    n = comm.n
    sbuf = (torch.cat([flat_leaves[i].reshape(n, -1) for i in small_ix], dim=1)
            if len(small_ix) > 1 else flat_leaves[small_ix[0]].reshape(n, -1))
    ssum = comm.psum(sbuf)
    out: dict[int, torch.Tensor] = {}
    off = 0
    for i in small_ix:
        shape = flat_leaves[i].shape[1:]
        sz = math.prod(shape)
        out[i] = ssum[off:off + sz].reshape(shape)
        off += sz
    return out


def pack_param_groups(flat_leaves: Sequence[torch.Tensor],
                      bucket: WireBucket, m: int) -> torch.Tensor:
    """Lay the bucket's *parameter* (or optimizer-state) leaves out in the
    decoded-buffer layout: an ``(bucket.size, m)`` f32 view whose rows
    ``[slot.offset, slot.offset + slot.size)`` hold leaf ``slot.leaf_index``
    exactly where ``unpack_bucket`` reads that leaf's decoded gradient.
    Rows in the alignment gaps and the tail are zeros.  (The operand layout
    of the fused decode-plus-apply path.)"""
    like = flat_leaves[bucket.slots[0].leaf_index]
    parts: list[torch.Tensor] = []
    pos = 0
    for s in bucket.slots:
        if s.offset > pos:
            parts.append(_gap(s.offset - pos, like, torch.float32, m))
        x = leaf_to_groups(
            flat_leaves[s.leaf_index].to(torch.float32), s.plan, m)
        parts.append(torch.movedim(x, 1, -1).reshape(s.size, m))
        pos = s.offset + s.size
    if bucket.size > pos:
        parts.append(_gap(bucket.size - pos, like, torch.float32, m))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unpack_param_groups(buf: torch.Tensor, bucket: WireBucket,
                        flat_like: Sequence[Any]) -> dict[int, torch.Tensor]:
    """Invert ``pack_param_groups``: slice the updated ``(bucket.size, m)``
    buffer back into leaf layouts, cast to each leaf's original dtype
    (``flat_like`` supplies the dtypes).  Returns {leaf_index: leaf}."""
    out = unpack_bucket(buf, bucket)
    return {i: v.to(flat_like[i].dtype) for i, v in out.items()}


def unpack_bucket(decoded: torch.Tensor,
                  bucket: WireBucket) -> dict[int, torch.Tensor]:
    """Invert the packing on the decoded ``(bucket.size, m)`` buffer: static
    slices from the slot table, reshaped back through ``groups_to_leaf`` into
    each leaf's original layout.  Returns {leaf_index: gradient leaf}."""
    m = decoded.shape[1]
    out: dict[int, torch.Tensor] = {}
    for s in bucket.slots:
        seg = decoded[s.offset:s.offset + s.size]             # (size, m)
        V, rest = s.enc_shape[0], s.enc_shape[1:]
        x = seg.reshape(V, *rest, m)
        x = torch.movedim(x, -1, 1)                           # (V, m, *rest)
        out[s.leaf_index] = groups_to_leaf(x, s.plan)
    return out
