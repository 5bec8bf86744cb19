"""The coded forward pass: gradient-coding codes repurposed for inference.

Training encodes per-subset *gradients* so the master can decode their sum
from any ``n - s`` responders.  Serving wants each request's own output, and
gets it from the same code objects: the decode identity behind
``repro_torch.coding`` is per subset (``sum_{i in holders(j)} W_i C_ij^T =
I_m``), so placing each subset's coded forward output in a *disjoint block*
of the wire makes the blockwise decode exact per block.

Layout.  The engine batch is ``B = k * b`` requests; the coded data pipeline
(``repro_torch.data.CodedBatcher``) places subset ``j`` = rows
``j*b:(j+1)*b`` redundantly on its ``d``-cyclic holders, the ``(n, d, b,
...)`` layout training uses.  Each replica runs the family's batched forward
on its ``d`` assigned subsets (compute redundancy ``d``, the paper's price),
flattens subset ``j``'s output to ``S_out = b * prod(out_shape)`` values,
zero-pads to ``q * m`` (``q = ceil(S_out / m)``) and folds it through the
codec backend's encode with its coefficient row ``C[i, j]`` (the CUDA
``coded_encode`` on the card): an ``m``-fold smaller payload.  The ``(q,)``
encoding lands at offset ``j * q`` of a flat ``(L,)`` wire buffer (``L =
k * q`` rounded up to ``lcm(WIRE_ALIGN, n)`` so the a2a schedule can slice it
``n`` ways).  One ``Codec.decode_packed`` recovers every block: decoded rows
``j*q:(j+1)*q`` are subset ``j``'s ``(q, m)`` output.

The reference runs the replicas as a ``shard_map`` over a device mesh; here
they are the ``n`` workers of a ``repro_torch.comm`` group, walked in a
Python loop (see ``train/coded_step.py``): all ``n`` of them under the
default single-process group, a rank's block (``comm.workers``) under a
``DistComm``.  The placed batch, ``C``, ``rho`` and ``mask`` keep the
global replica index; the rows of the wire (and of the partial
certificate's sums) are this process's replicas, in order.  Every rank
decodes the gathered wire (the ``gather`` schedule), or its slices and
then gathers them (``a2a``), or sums the raw rows (``psum``), so every
rank ends with the whole decoded ``(B, *out_shape)`` output, bitwise the
single-process one.

Hedging.  ``W`` is the host float64 solve with zero rows at stragglers
(``coding.make_step_inputs``) and the wire masks straggler payloads to
exact zero, so the decode is bit-for-bit independent of the straggler
replicas' payloads: waiting for only the fastest ``n - s`` replicas returns
the same bits as waiting for all ``n`` under the same ``W``.

Past-``s`` failures use the partial-recovery certificate: the least-squares
``W`` plus ``err_factor * sqrt(sum_j ||y_j||^2)`` bounds the L2 decode error
across covered subsets, and subsets with no live holder are reported as
failed request rows.

The ``psum`` schedule is replicated serving (each live holder contributes
its subset's raw output, rho-weighted so duplicates average exactly), the
like-for-like uncoded baseline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from .. import coding
from .._device import resolve_device
from ..comm import Comm, make_local_comm, stack_rows
from ..core import GradCode
from ..models import api as model_api
from ..models import common as cm


@dataclasses.dataclass(frozen=True)
class ForwardArtifacts:
    """Everything the serving engine needs to run one coded forward.

    ``step(params, batch, W, mask, rho[, err_factor])`` takes the placed
    ``(n, d, b, ...)`` batch on the codec's device and returns the decoded
    ``(B, *out_shape)`` f32 outputs; built with ``spec.partial`` it takes the
    ``err_factor`` scalar too and returns ``(outputs, err_bound)``.
    ``step_inputs`` maps a straggler pattern to the device inputs, as
    ``repro_torch.train.coded_step.StepArtifacts`` does for training.
    """

    step: Callable
    codec: coding.Codec
    comm: Comm
    spec: coding.SchemeSpec
    out_shape: tuple[int, ...]     # per-request output shape (sans batch)
    batch_per_subset: int          # b: requests per data subset
    partial: bool = False

    @property
    def code(self) -> GradCode:
        """The bound gradient code (n, d, s, m)."""
        return self.codec.code

    def step_inputs(self, stragglers=()) -> dict[str, torch.Tensor]:
        """``W``/``mask``/``rho`` on the device for a straggler pattern
        (plus ``err_factor`` when the step was built ``partial``)."""
        inp = coding.make_step_inputs(self.codec.code, stragglers,
                                      partial=self.partial)
        return {k: torch.as_tensor(v).to(self.codec.device)
                for k, v in inp.items()}


def make_coded_forward(cfg, code: GradCode, *,
                       spec: coding.SchemeSpec | None = None,
                       batch_per_subset: int = 1,
                       seq_len: int = 128,
                       window: int = 0,
                       device: str | torch.device = "cuda",
                       comm: Comm | None = None) -> ForwardArtifacts:
    """Build the coded forward for one architecture.

    ``spec`` is the same ``SchemeSpec`` that ``make_coded_train_step``
    accepts.  Serving rejects the training-only levers (``pipelined`` /
    ``fuse_apply``): a forward pass has no optimizer state to overlap or
    fuse into.

    ``batch_per_subset`` is ``b``; the engine batch is ``B = k * b`` with
    ``k = code.num_subsets`` and arrives in the coded ``(n, d, b, ...)``
    layout.  ``seq_len`` is the LM families' prompt length the server pads
    requests to (an encdec request's frames).  ``device`` defaults to the
    card and raises when there is none; ``comm`` defaults to the
    single-process group of ``code.n`` replicas on it (a ``DistComm`` splits
    them over ranks, each of which runs its own replicas' forwards).
    """
    spec = spec if spec is not None else coding.SchemeSpec()
    if spec.pipelined or spec.fuse_apply:
        raise ValueError(
            "pipelined/fuse_apply are train-step levers (they overlap or "
            "fuse the optimizer update); the serving forward has neither — "
            "build the CodedServer from a spec without them")
    dev = resolve_device(device)
    comm = comm or make_local_comm(code.n, dev)
    n = comm.n
    workers = comm.workers
    if code.n != n:
        raise ValueError(f"code.n={code.n} != data-parallel degree {n}")
    partial = spec.partial
    codec = spec.make_codec(code, dev)
    forward_fn = model_api.make_forward(cfg, window=window)

    k = getattr(code, "num_subsets", n)
    b = int(batch_per_subset)
    d, m = code.d, code.m
    sub_shapes = _subset_batch_shapes(cfg, b, seq_len)
    out_shape = _out_shape(cfg)
    s_out = b * math.prod(out_shape)
    q = -(-s_out // m)                       # ceil: rows of m per subset
    align = math.lcm(coding.WIRE_ALIGN, n)   # a2a slices the wire n ways
    L = -(-(k * q) // align) * align

    f32 = torch.float32
    C = torch.as_tensor(code.C).to(dtype=f32, device=dev)        # (n, d, m)
    blk = code.placement()                                       # (n, d) host
    valid = torch.as_tensor(code.slot_mask()).to(dtype=f32, device=dev)

    def subset(batch, i, slot):
        if set(batch) != set(sub_shapes):
            raise ValueError(f"batch keys {sorted(batch)} != "
                             f"{sorted(sub_shapes)} for family {cfg.family!r}")
        sub = {}
        for key, x in batch.items():
            if tuple(x.shape[:3]) != (n, d, b):
                raise ValueError(f"batch[{key!r}] {tuple(x.shape)} is not in "
                                 f"the coded (n, d, b, ...) = {(n, d, b)} layout")
            sub[key] = x[i, slot]
        return sub

    def body(params, batch, W, mask, rho, err_factor=None):
        rows, ss_rows = [], []
        for i in workers:
            buf = torch.zeros((L,), dtype=f32, device=dev)
            ss_acc = torch.zeros((), dtype=f32, device=dev)
            for slot in range(d):
                y = forward_fn(params, subset(batch, i, slot)).to(f32)
                flat = y.reshape(-1)
                G = F.pad(flat, (0, q * m - s_out)).reshape(1, q, m)
                enc = codec.backend.encode(G, C[i, slot][None], out_dtype=f32)
                # scatter-add at the subset's block (a hetero code's padded
                # slots carry zero valid weight: their double-add adds zero)
                off = int(blk[i, slot]) * q
                buf[off:off + q] += enc * valid[i, slot]
                if partial:
                    ss_acc = ss_acc + rho[i, slot] * torch.sum(flat * flat)
            rows.append(codec.to_wire(buf, mask[i]))
            ss_rows.append(ss_acc)
        dec = codec.decode_packed(
            stack_rows(rows, (L,), codec.wire_dtype, dev), W, comm)  # (L, m)
        out = dec[:k * q].reshape(k, q * m)[:, :s_out].reshape(k * b,
                                                              *out_shape)
        if partial:
            return out, err_factor * torch.sqrt(
                comm.psum(stack_rows(ss_rows, (), f32, dev)))
        return out

    def body_psum(params, batch, W, mask, rho, err_factor=None):
        # replicated baseline: live holders contribute raw outputs, the rho
        # equal split makes duplicated subsets average exactly (the train
        # step's straggler-aware psum body)
        rows = []
        for i in workers:
            buf = torch.zeros((k * s_out,), dtype=f32, device=dev)
            for slot in range(d):
                y = forward_fn(params, subset(batch, i, slot)).to(f32)
                off = int(blk[i, slot]) * s_out
                buf[off:off + s_out] += y.reshape(-1) * rho[i, slot]
            rows.append(buf)
        out = comm.psum(stack_rows(rows, (k * s_out,), f32, dev)).reshape(
            k * b, *out_shape)
        if partial:
            return out, torch.zeros((), dtype=f32, device=dev)  # rho drops exactly
        return out

    step = body if codec.schedule.uses_encoding else body_psum
    return ForwardArtifacts(step=step, codec=codec, comm=comm, spec=spec,
                            out_shape=out_shape, batch_per_subset=b,
                            partial=partial)


def _out_shape(cfg) -> tuple[int, ...]:
    """Per-request output shape of the family's forward (the reference reads
    it off an abstract forward): a logit for ``linear``, the last-token
    logits for the LM families."""
    model_api.get_module(cfg)                 # raises for a family not ported
    return () if cfg.family == "linear" else (cfg.vocab,)


def _subset_batch_shapes(cfg, b: int, seq: int) -> dict:
    """One subset's batch, ``{name: (shape, dtype)}`` (the forward's
    per-slot operands); ``seq`` counts tokens, after a VLM's patches, and
    an encdec request's frames, its only operand."""
    if cfg.family == "linear":
        return {"x": ((b, cfg.d_model), torch.float32)}
    if cfg.family == "encdec":
        return {"embeds": ((b, seq, cfg.d_model), cm.cdtype(cfg))}
    shapes = {"tokens": ((b, seq), torch.int32)}
    if cfg.family == "vlm":
        shapes["embeds"] = ((b, cfg.n_frontend_tokens, cfg.d_model),
                            cm.cdtype(cfg))
    return shapes


def failed_request_rows(code: GradCode, stragglers, batch_per_subset: int,
                        ) -> list[int]:
    """Batch rows whose subset lost every holder (unrecoverable requests).

    Only non-empty past the design ``s`` in partial mode: subset ``j``
    covers rows ``j*b:(j+1)*b`` of the engine batch.
    """
    st = set(int(i) for i in stragglers)
    placement, valid = code.placement(), code.slot_mask()
    covered: set[int] = set()
    for i in range(code.n):
        if i in st:
            continue
        covered.update(int(j) for slot, j in enumerate(placement[i])
                       if valid[i, slot])
    b = batch_per_subset
    return [r for j in range(code.num_subsets) if j not in covered
            for r in range(j * b, (j + 1) * b)]
