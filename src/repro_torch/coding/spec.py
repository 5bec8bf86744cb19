"""`SchemeSpec`: one frozen value object naming a complete coding scheme.

The scheme levers — collective schedule, compute backend, packed wire,
partial recovery, async pipelining, fused apply, wire dtype — live in one
hashable dataclass that every consumer accepts:

>>> spec = SchemeSpec(schedule="a2a", encode_dtype="bfloat16")
>>> spec.replace(packed=False).packed
False

``make_coded_train_step(cfg, code, opt, spec=spec)`` and
``Trainer(..., spec=spec)`` consume the same instance.  What stays *out* of
the spec: anything workload-specific (``grad_scale``) or cluster-specific
(the code object, the device, the worker group) — a spec is the reusable
"how to aggregate", not the "what" or the "where".

The pipelined (stale-by-one) step is not ported yet: ``pipelined=True`` and
``fuse_apply=True`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .backends import BACKEND_NAMES, CodecBackend
from .codec import Codec, make_codec
from .schedules import get_schedule
from .wire import wire_dtype

# the seven levers the spec consolidates
SPEC_FIELDS = ("schedule", "backend", "packed", "partial", "pipelined",
               "fuse_apply", "encode_dtype")


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """Frozen bundle of every scheme lever.

    schedule: collective choreography — "gather" | "a2a" | "psum" (the
    uncoded baseline; see ``repro_torch.coding.schedules``).

    backend: codec compute backend — "auto" | "ref" | "hopper" or a
    ``CodecBackend`` instance ("auto" follows the explicit device: the CUDA
    kernels on a cuda device, the plain versions on the cpu).

    packed: ride the bucketed flat wire buffers of ``coding.packing``
    (O(1) collectives per step); ``False`` is the per-leaf escape hatch.

    partial: build the partial-recovery step — straggler sets larger than
    the design ``s`` decode approximately with an ``err_factor`` error
    certificate instead of raising.

    pipelined / fuse_apply: the async stale-by-one step and its fused
    decode-plus-apply; not ported yet.

    encode_dtype: wire dtype of the transmitted encodings ("float32" |
    "bfloat16": the types the kernels take).
    """

    schedule: str = "gather"
    backend: str | CodecBackend = "auto"
    packed: bool = True
    partial: bool = False
    pipelined: bool = False
    fuse_apply: bool | None = None
    encode_dtype: str = "float32"

    def __post_init__(self):
        """Reject unknown names and the levers not ported yet, eagerly."""
        if self.pipelined:
            raise NotImplementedError(
                "pipelined=True: the pipelined (stale-by-one) step is not "
                "ported yet")
        if self.fuse_apply:
            raise NotImplementedError(
                "fuse_apply=True is a lever of the pipelined (stale-by-one) "
                "step, which is not ported yet")
        if isinstance(self.schedule, str):
            get_schedule(self.schedule)
        if isinstance(self.backend, str) and self.backend not in BACKEND_NAMES:
            raise ValueError(f"unknown codec backend {self.backend!r}; "
                             f"expected one of {BACKEND_NAMES}")
        wire_dtype(self.encode_dtype)

    def replace(self, **changes: Any) -> "SchemeSpec":
        """A copy with the given levers changed (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)

    def make_codec(self, code, device: str | torch.device = "cuda") -> Codec:
        """Bind the spec's schedule/backend/wire-dtype levers to a code on
        ``device`` (default: the card; raises when there is none)."""
        return make_codec(code, schedule=self.schedule, backend=self.backend,
                          wire_dtype=self.encode_dtype, device=device)

    @property
    def uses_encoding(self) -> bool:
        """Whether the schedule transmits coded encodings (psum does not)."""
        return get_schedule(self.schedule).uses_encoding
