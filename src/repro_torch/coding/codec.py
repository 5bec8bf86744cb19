"""The ``Codec``: one object owning the per-leaf coded-aggregation lifecycle.

A codec binds a gradient code to an aggregation ``Schedule`` and a compute
``CodecBackend`` on one device and exposes the phases the train step needs:

  plan    — choose each leaf's grouping dimension (``plan_tree``),
  encode  — fold one subset's gradient into the l/m encoding (eq. 17/18);
            the pipelined step folds it straight into its wire-bucket slot
            (``encode_into``),
  wire    — mask stragglers + cast to the wire dtype,
  pack    — lay every coded encoding into bucketed flat wire buffers
            (``packing.py``; static ``PackPlan``, O(1) collectives/bucket),
  decode  — run the schedule's collective choreography + contraction
            (eq. 19-21); ``decode_apply_packed`` fuses the SGD-momentum
            update into it,
  unpack  — static slices + ``groups_to_leaf`` back to leaf layouts.

A parameter tree is a flat ``dict[str, Tensor]``; "flat leaves" are its
values in dict order.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Mapping, Sequence

import torch

from .._device import resolve_device
from ..comm import Comm
from .backends import CodecBackend, TorchRefBackend, resolve_backend
from .layout import flatten_rest, leaf_to_groups, unflatten_rest
from .packing import (LeafSlot, PackPlan, make_pack_plan, pack_bucket,
                      pack_param_groups, unpack_bucket, unpack_param_groups)
from .plan import LeafPlan, coded_fraction, plan_tree
from .schedules import Schedule, get_schedule
from .wire import to_wire
from .wire import wire_dtype as _wire_dtype

if TYPE_CHECKING:
    from ..core.schemes import GradCode

_REF = TorchRefBackend()


# --------------------------------------------------- functional encode layer
def _encode_operand(g: torch.Tensor, plan: LeafPlan,
                    m: int) -> tuple[torch.Tensor, tuple[int, ...]]:
    """A gradient leaf as the contiguous (1, V, m[, R]) operand of the
    encode kernels (a leaf grouped on a later dimension comes out of
    ``leaf_to_groups`` strided), and its trailing ``rest`` dims."""
    x = leaf_to_groups(g, plan, m)                  # (V, m, *rest)
    return flatten_rest(x, 2)[None].contiguous(), tuple(x.shape[2:])


def encode_leaf(g: torch.Tensor, coef: torch.Tensor, plan: LeafPlan,
                backend: CodecBackend = _REF) -> torch.Tensor:
    """Fold one subset's gradient leaf into the l/m-sized encoding.

    g: (..., Dg, ...);  coef: (m,)  ->  (Dg/m, *rest) contribution.
    The fold is the d=1 slice of the canonical (d, V, m[, R]) contraction, so
    both backends serve it.
    """
    assert plan.coded
    m = coef.shape[0]
    G, rest = _encode_operand(g, plan, m)
    out = backend.encode(G, coef.reshape(1, m), out_dtype=g.dtype)
    return unflatten_rest(out, 1, rest)             # (V, *rest)


# -------------------------------------------------------------- the subsystem
@dataclasses.dataclass(frozen=True)
class Codec:
    """Gradient code + schedule + backend on a device, with the leaf
    lifecycle methods.  ``device`` defaults to the card and raises when
    there is none, as ``make_codec`` does; pass ``"cpu"`` for the host."""
    code: "GradCode"
    schedule: Schedule
    backend: CodecBackend
    wire_dtype: torch.dtype = torch.float32
    device: str | torch.device = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # ---- planning
    def plan(self, tree: Mapping[str, Any],
             specs: Mapping[str, Any] | None = None) -> dict[str, LeafPlan]:
        """Choose every leaf's grouping dimension (``plan_tree``), honouring
        the schedule's extra divisibility (a2a slices encodings n ways) and
        the model-axis dims of ``specs`` (``param_specs``)."""
        return plan_tree(tree, self.code.m,
                         self.schedule.n_split(self.code.n), specs)

    def coded_fraction(self, tree, plans) -> float:
        """Fraction of gradient elements covered by the code (rest -> psum)."""
        return coded_fraction(tree, plans)

    # ---- encode
    def encode_leaf(self, g: torch.Tensor, coef: torch.Tensor,
                    plan: LeafPlan) -> torch.Tensor:
        """Fold one subset's gradient leaf into the l/m encoding with this
        worker's coefficient row (paper eq. 17/18) on the bound backend."""
        return encode_leaf(g, coef, plan, self.backend)

    def encoding_zero(self, p, plan: LeafPlan) -> torch.Tensor:
        """f32 zero accumulator in the encoding layout of leaf ``p``."""
        shape = tuple(p.shape)
        if plan.coded:
            k = plan.group_dim
            shape = (shape[k] // self.code.m,) + shape[:k] + shape[k + 1:]
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    # ---- fused encode (encode straight into the wire layout)
    def bucket_acc_zeros(self, pplan: PackPlan) -> list[torch.Tensor]:
        """Flat f32 zero accumulators, one per wire bucket: the fused encode
        fold's carry.  Alignment gaps and the n-divisible tail are never
        written, so they stay exactly zero on the wire (matching
        ``pack_bucket``'s explicit zero padding bit for bit)."""
        return [torch.zeros((b.size,), dtype=torch.float32,
                            device=self.device) for b in pplan.buckets]

    def encode_into(self, buf: torch.Tensor, g: torch.Tensor,
                    coef: torch.Tensor, slot: LeafSlot) -> torch.Tensor:
        """Fold one subset's gradient leaf straight into its bucket slot:
        ``buf[slot] += encode(g, coef)`` in place through the backend's
        accumulating encode, skipping the materialise-then-pack copy of the
        synchronous path.  ``buf`` is a flat contiguous f32 bucket (or one
        worker's row of a stack of them); ``g`` must already be f32 (the
        fold accumulates in f32, like the per-leaf path's ``encoding_zero``
        carry).  Returns ``buf``."""
        m = coef.shape[0]
        G, _ = _encode_operand(g, slot.plan, m)
        acc = buf[slot.offset:slot.offset + slot.size]
        if G.ndim == 4:
            acc = acc.view(slot.enc_shape[0], G.shape[3])
        self.backend.encode_acc(acc, G, coef.reshape(1, m))
        return buf

    # ---- wire
    def to_wire(self, e: torch.Tensor, mask_i: torch.Tensor) -> torch.Tensor:
        """Mask the straggler payload (transmits nothing) + cast to the wire."""
        return to_wire(e, mask_i, self.wire_dtype)

    # ---- pack / unpack
    def pack_plan(self, tree, plans) -> PackPlan:
        """Static wire layout of every coded leaf (see ``packing.py``)."""
        return make_pack_plan(tree, plans, m=self.code.m, n=self.code.n,
                              wire_dtype=self.wire_dtype)

    def pack(self, flat_leaves: Sequence[torch.Tensor],
             pplan: PackPlan) -> list[torch.Tensor]:
        """One worker's wire-masked leaves (dict order) -> one flat buffer
        per bucket."""
        return [pack_bucket(flat_leaves, b, self.wire_dtype)
                for b in pplan.buckets]

    def wire_rows(self, pplan: PackPlan,
                  rows: int | None = None) -> list[torch.Tensor]:
        """One zero ``(rows, size)`` buffer in the wire dtype per bucket:
        the wire of each worker this process computes (``rows``, default
        all ``n``; ``len(comm.workers)`` under a multi-process group), a row
        each, filled from ``pack`` (or, f32, by the fused encode in place).
        Gaps and tails stay exactly zero."""
        rows = self.code.n if rows is None else rows
        return [torch.zeros((rows, b.size), dtype=self.wire_dtype,
                            device=self.device) for b in pplan.buckets]

    def unpack(self, decoded_bufs, pplan: PackPlan) -> dict[int, torch.Tensor]:
        """Per-bucket (L, m) decoded buffers -> {leaf_index: gradient leaf}."""
        out: dict[int, torch.Tensor] = {}
        for dec, b in zip(decoded_bufs, pplan.buckets):
            out.update(unpack_bucket(dec, b))
        return out

    def pack_params(self, flat_leaves, pplan: PackPlan) -> list[torch.Tensor]:
        """Param/momentum leaves -> one new (L, m) f32 bucket-layout buffer
        per bucket, row-aligned with the decoded gradient buffers (the fused
        decode-plus-apply operands; see ``packing.pack_param_groups``)."""
        return [pack_param_groups(flat_leaves, b, self.code.m)
                for b in pplan.buckets]

    def unpack_params(self, bufs, pplan: PackPlan,
                      flat_like) -> dict[int, torch.Tensor]:
        """Updated (L, m) buffers -> {leaf_index: leaf}, cast back to each
        leaf's dtype (``flat_like`` supplies the originals)."""
        out: dict[int, torch.Tensor] = {}
        for buf, b in zip(bufs, pplan.buckets):
            out.update(unpack_param_groups(buf, b, flat_like))
        return out

    # ---- decode
    def decode_weights(self, responders, *, partial: bool = False):
        """Host-side float64 decode-weight solve for a responder set.

        With ``partial=False`` (the paper's regime) the exact weights are
        returned and fewer than ``n - s`` responders raise.  With
        ``partial=True`` *any* responder set is accepted: returns the
        ``(W, err_factor)`` pair of the least-squares approximation, where
        ``err_factor * sqrt(sum_j ||g_j||^2)`` upper-bounds the L2 decode
        error.
        """
        if partial:
            return self.code.partial_decode_weights(responders)
        return self.code.decode_weights(responders)

    def decode_leaf(self, f_leaf: torch.Tensor, W: torch.Tensor,
                    plan: LeafPlan, comm: Comm) -> torch.Tensor:
        """Decode one coded leaf from its (n, V, *rest) per-worker encodings
        via the bound schedule's choreography."""
        return self.schedule.decode_leaf(f_leaf, W, plan, comm, self.backend)

    def decode_packed(self, bufs: torch.Tensor, W: torch.Tensor,
                      comm: Comm) -> torch.Tensor:
        """One bucket's collective + contraction: (n, L) -> (L, m) f32."""
        return self.schedule.decode_packed(bufs, W, comm, self.backend)

    def decode_apply_packed(self, bufs: torch.Tensor, W: torch.Tensor,
                            P: torch.Tensor, MU: torch.Tensor, comm: Comm, *,
                            lr: float, momentum: float, scale: float):
        """One bucket's collective + fused decode-and-SGD-momentum apply on
        its (L, m) param/momentum buffers: returns (p', mu', sum(g*g)).  See
        ``Schedule.decode_apply_packed``."""
        return self.schedule.decode_apply_packed(
            bufs, W, P, MU, comm, self.backend, lr=lr, momentum=momentum,
            scale=scale)


def make_codec(code: "GradCode", *, schedule: str | Schedule = "gather",
               backend: str | CodecBackend = "auto",
               wire_dtype="float32",
               device: str | torch.device = "cuda") -> Codec:
    """Resolve names to objects.  ``device`` defaults to the card and raises
    when there is none; ``backend='auto'`` follows it (cuda -> the CUDA
    kernels, cpu -> the plain versions; see ``backends.resolve_backend``)."""
    dev = resolve_device(device)
    return Codec(code=code, schedule=get_schedule(schedule),
                 backend=resolve_backend(backend, dev),
                 wire_dtype=_wire_dtype(wire_dtype), device=dev)
