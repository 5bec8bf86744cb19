"""Aggregation schedules over the worker group, as first-class objects.

- ``gather``  (paper-faithful): all_gather the l/m encodings, decode locally.
- ``a2a``     (beyond-paper):  all_to_all chunks of the encodings, decode the
              local 1/n slice, all_gather decoded slices.  ≈ l(1/m + 1)
              elements received per worker vs ≈ 2l for plain all-reduce.
- ``psum``    (baseline / fallback): straggler-aware weighted all-reduce —
              carries no encoding, so its decode path is the train step's
              plain rho-weighted sum.

Each schedule's decode contraction is delegated to a ``CodecBackend`` so the
same choreography runs on the plain versions or the CUDA kernels.  Inputs
carry the leading worker axis of ``repro_torch.comm``.  In SPMD every worker
ends with the same decoded gradient; the single-process group computes it
**once**: the gather schedule contracts the one gathered stack a single
time, the a2a schedule runs each worker's 1/n slice (n launches) and
concatenates them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..comm import Comm
from .backends import CodecBackend
from .layout import flatten_rest, groups_to_leaf, unflatten_rest
from .plan import LeafPlan


def _decode_stack(stacked: torch.Tensor, W: torch.Tensor,
                  backend: CodecBackend) -> torch.Tensor:
    """(n, V, *rest) x (n, m) -> (V, m, *rest), accumulated/returned in f32."""
    rest = tuple(stacked.shape[2:])
    F = flatten_rest(stacked, 2)
    dec = backend.decode(F, W, out_dtype=torch.float32)   # (V, m[, R])
    return unflatten_rest(dec, 2, rest)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Interface: how encoded leaves travel and get decoded."""
    name: str = "abstract"
    uses_encoding: bool = True

    def n_split(self, n: int) -> int:
        """Extra divisibility the planner must guarantee on the grouping dim
        (beyond m): 1 unless the schedule slices encodings n ways."""
        return 1

    def recv_elems_per_worker(self, l: int, n: int, m: int) -> float:
        """Wire-cost model: elements *received* per worker to aggregate one
        l-element gradient (multiply by the wire itemsize for bytes)."""
        raise NotImplementedError

    def decode_leaf(self, f_leaf: torch.Tensor, W: torch.Tensor,
                    plan: LeafPlan, comm: Comm,
                    backend: CodecBackend) -> torch.Tensor:
        """Decode one leaf from its ``(n, V, *rest)`` per-worker encodings
        into the summed gradient in the leaf's own layout."""
        raise NotImplementedError

    def decode_packed(self, bufs: torch.Tensor, W: torch.Tensor, comm: Comm,
                      backend: CodecBackend) -> torch.Tensor:
        """Decode one packed wire bucket: ``bufs`` is the (n, L) stack of
        per-worker flat buffers (``repro_torch.coding.packing``), L a
        multiple of lcm(128, n).  Returns the (L, m) decoded groups in f32 —
        the same per-element contraction as ``decode_leaf``, issued as ONE
        collective choreography for the whole bucket."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GatherSchedule(Schedule):
    """Paper-faithful master emulation: all_gather encodings, decode locally."""
    name: str = "gather"

    def recv_elems_per_worker(self, l: int, n: int, m: int) -> float:
        """all_gather of the (l/m)-element encodings: n-1 peer encodings."""
        return (n - 1) * l / m

    def decode_leaf(self, f_leaf, W, plan, comm, backend):
        """all_gather the leaf's encodings, contract the (n, V, *rest) stack
        with W once."""
        gathered = comm.all_gather(f_leaf)                # (n, V, *rest)
        return groups_to_leaf(_decode_stack(gathered, W, backend), plan)

    def decode_packed(self, bufs, W, comm, backend):
        """One all_gather + one (n, L) x (n, m) contraction for the whole
        bucket."""
        gathered = comm.all_gather(bufs)                  # (n, L)
        return backend.decode(gathered, W, out_dtype=torch.float32)  # (L, m)


@dataclasses.dataclass(frozen=True)
class AllToAllSchedule(Schedule):
    """Beyond-paper: all_to_all encoding chunks, decode the local 1/n slice
    of the sum, all_gather decoded slices (second hop travels at the wire
    dtype too)."""
    name: str = "a2a"

    def n_split(self, n: int) -> int:
        """The a2a schedule slices encodings n ways along the grouping dim."""
        return n

    def recv_elems_per_worker(self, l: int, n: int, m: int) -> float:
        """all_to_all of the l/m encoding + all_gather of decoded slices."""
        return (n - 1) * l / (m * n) + (n - 1) * l / n

    def _exchange_decode(self, x, W, comm, backend):
        """(n, v, *rest) per-worker buffers -> (v, m, *rest) f32: exchange
        chunks, decode worker p's (n, v/n, *rest) slice for each p, gather
        the decoded slices at the wire dtype."""
        ex = comm.all_to_all(x)                           # (n, n, c, *rest)
        dec = torch.stack([_decode_stack(ex[p], W, backend)
                           for p in range(comm.n)])       # (n, c, m, *rest)
        full = comm.all_gather(dec.to(x.dtype)).to(torch.float32)
        return full.reshape(x.shape[1], *dec.shape[2:])   # (v, m, *rest)

    def decode_leaf(self, f_leaf, W, plan, comm, backend):
        """all_to_all encoding chunks, decode each 1/n slice of the sum,
        all_gather the decoded slices (both hops at the wire dtype)."""
        v = f_leaf.shape[1]
        assert v % comm.n == 0, f"a2a needs n | Dg/m, got {v} % {comm.n}"
        return groups_to_leaf(self._exchange_decode(f_leaf, W, comm, backend),
                              plan)

    def decode_packed(self, bufs, W, comm, backend):
        """One all_to_all of the bucket's n chunks, one (n, L/n) contraction
        per worker, one all_gather of the decoded slices."""
        L = bufs.shape[1]
        assert L % comm.n == 0, f"a2a needs n | bucket length, got {L} % {comm.n}"
        return self._exchange_decode(bufs, W, comm, backend)


@dataclasses.dataclass(frozen=True)
class PsumSchedule(Schedule):
    """Uncoded baseline: rho-weighted all-reduce, no encode/decode."""
    name: str = "psum"
    uses_encoding: bool = False

    def recv_elems_per_worker(self, l: int, n: int, m: int) -> float:
        """Ring all-reduce: reduce-scatter + all-gather phases, ~2l total."""
        return 2 * (n - 1) * l / n

    def decode_leaf(self, f_leaf, W, plan, comm, backend):
        """Plain all-reduce — the rho weighting happened at accumulation."""
        return comm.psum(f_leaf)


SCHEDULES = {s.name: s for s in
             (GatherSchedule(), AllToAllSchedule(), PsumSchedule())}


def get_schedule(schedule: str | Schedule) -> Schedule:
    """Resolve a schedule name ("gather" | "a2a" | "psum") to its object;
    ``Schedule`` instances pass through unchanged."""
    if isinstance(schedule, Schedule):
        return schedule
    try:
        return SCHEDULES[schedule]
    except KeyError:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"expected one of {tuple(SCHEDULES)}") from None
