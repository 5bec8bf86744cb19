"""The coded train step: the paper's gradient coding wired into a generic
train step usable with any parameter dict and any loss function.

Layout: the batch arrives in the redundant coded layout (n, d, b, ...) —
dim 0 the worker, dim 1 the worker's d assigned subsets.  The step walks
the workers of its process (``comm.workers``: all ``n`` of them under the
default single-process group, a rank's block under a ``DistComm``) in a
Python loop where the reference runs a ``shard_map``:

  1. per worker, loop over its d subsets, computing each subset's gradient
     with ``torch.autograd.grad`` (activation memory = 1 subset; the compute
     redundancy d is the paper's intended cost),
  2. fold each subset gradient into the l/m encoding on the fly with the
     worker's coefficient rows C[i, j, :] (paper eq. 17/18 — the ``d = 1``
     call of the encode kernel; the (d, l) partial-gradient matrix is never
     materialised), adding in f32 in slot order,
  3. multiply by the responder mask (stragglers transmit nothing; proves
     the decode is independent of straggler payloads),
  4. pack the coded encodings into the static ``PackPlan``'s bucketed flat
     wire buffers, each worker straight into its row of one ``(w, L)``
     buffer per bucket, ``w`` the process's workers (default;
     ``packed=False`` keeps the per-leaf escape hatch) and decode the
     summed gradient with the host-computed float64 weights W (zero rows
     at stragglers) via the gather or a2a schedule —
     one collective choreography + one contraction per bucket.  Every
     reference worker decodes the same gathered stack; the single-process
     group decodes it once per bucket, and so does every rank of a
     ``DistComm``,
  5. run the optimizer update (on every rank alike: the parameters stay
     replicated, as in the reference's SPMD).

``batch``, ``C``, ``rho`` and ``mask`` keep the global worker index; the
rows of a wire or side buffer are this process's workers, in order.

All coding phases are delegated to a ``repro_torch.coding.Codec``:
``schedule`` picks the choreography (gather / a2a / psum), ``backend`` the
encode/decode implementation ("auto" -> the CUDA kernels on a cuda device,
the plain versions on the cpu).

With ``SchemeSpec(pipelined=True)`` the build also carries the async
stale-by-one step (``StepArtifacts.pipeline``, driven by
``repro_torch.train.pipeline.PipelineDriver``): ``fill`` encodes one batch
into the wire state, ``steady`` decodes the in-flight wire and applies its
update while encoding the current batch at the pre-update params, ``drain``
retires the last wire.  The encode folds each subset gradient straight into
the 128-aligned wire buckets (``Codec.encode_into``, the accumulating encode
kernel); ``fuse_apply=True`` decodes and applies SGD-momentum in one kernel
per bucket (``Codec.decode_apply_packed``).  Parity contract: fill
immediately followed by drain == the synchronous step, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch

from .. import coding
from .._device import resolve_device
from ..comm import Comm, make_local_comm, stack_rows
from ..core import GradCode
from ..models import api as model_api
from ..optim import Optimizer
from .pipeline import PipelineFns

Params = dict


@dataclasses.dataclass(frozen=True)
class StepArtifacts:
    """Everything a caller needs to run one coded train step.

    ``step(params, opt_state, batch, W, mask, rho[, err_factor])`` returns
    ``(new_params, new_opt_state, metrics)``; ``aggregate(params, batch, W,
    mask, rho[, err_factor])`` stops before the optimizer and returns
    ``(grads, metrics)`` — the decoded, scaled gradient dict.  ``batch`` is
    the placed ``(n, d, b, ...)`` dict on the step's device; metrics are
    0-d tensors (``loss``, ``grad_norm`` and, on a partial-recovery step,
    ``decode_err_bound``).  Straggler patterns are *inputs*, so one step
    serves every pattern.
    """
    step: Callable
    aggregate: Callable
    plans: dict
    coded_fraction: float
    codec: coding.Codec
    comm: Comm
    pack_plan: coding.PackPlan | None = None
    partial: bool = False
    spec: coding.SchemeSpec | None = None   # the resolved scheme levers
    pipelined: bool = False
    fuse_apply: bool = False
    pipeline: PipelineFns | None = None     # fill / steady / drain

    def step_inputs(self, stragglers=()) -> dict[str, torch.Tensor]:
        """Drop-pattern hook: `W`/`mask`/`rho` on the step's device for a
        straggler set (the host-side float64 solve for this responder
        pattern).  On a partial-recovery step the dict also carries the
        pattern's ``err_factor`` certificate scalar."""
        inp = coding.make_step_inputs(self.codec.code, stragglers,
                                      partial=self.partial)
        return {k: torch.as_tensor(v).to(self.codec.device)
                for k, v in inp.items()}


def pipelining_supported(comm: Comm, schedule: str = "gather") -> bool:
    """Whether the async pipelined step is available for ``schedule`` on
    the worker group ``comm``: the schedule must carry an encoding (psum has
    no wire to double-buffer).  Every ``Comm`` of the port runs its
    collectives natively, so the group itself never rules it out (the
    reference also checks its runtime's collective lowering here)."""
    del comm
    return coding.get_schedule(schedule).uses_encoding


def make_coded_train_step(cfg, code: GradCode, optimizer: Optimizer, *,
                          spec: coding.SchemeSpec | None = None,
                          grad_scale: float | None = None,
                          device: str | torch.device = "cuda",
                          comm: Comm | None = None,
                          loss_fn: Callable | None = None,
                          params_like: Mapping[str, Any] | None = None,
                          ) -> StepArtifacts:
    """Build the coded train step for one workload.

    cfg: a ``ModelConfig`` of a ported family; its loss and parameter shapes
    come from ``repro_torch.models.api``.  Any other workload passes
    ``loss_fn(params, batch) -> scalar`` and ``params_like`` (a dict with the
    parameters' shapes, e.g. the parameters themselves) and may leave
    ``cfg`` as ``None``.

    code: a uniform ``GradCode`` or a heterogeneous ``HeteroCode`` — the
    batch layout's subset-slot count is ``code.d`` (the max per-worker load
    for hetero plans, whose padded slots carry zero encode/rho weight).

    spec: a ``SchemeSpec`` bundling every scheme lever (default: gather
    schedule, packed wire, f32 wire, backend by device).

    grad_scale: decoded gradients are multiplied by this (default 1/k with
    k = ``code.num_subsets`` so the update equals uncoded *mean*-gradient
    descent when per-subset losses are means; the paper's linear workload
    uses sum losses and scale 1).

    device: where the step runs; defaults to the card and raises when there
    is none.  comm: the worker group (default: the single-process group of
    ``code.n`` workers on ``device``; a ``DistComm`` splits them over
    ranks, each of which computes its own workers' subsets).

    spec.pipelined: also build the async three-phase step
    (``StepArtifacts.pipeline``); the synchronous step is built as well and
    is unchanged.  On a cuda device ``steady`` runs its decode half on a
    side CUDA stream beside the encode half on the current stream and joins
    the two before it returns; on the cpu the halves run one after the
    other.

    spec.fuse_apply: fuse each bucket's decode with the SGD-momentum update
    (``optimizer.kind == "sgd"`` only).  Params and momentum stay bit-equal
    to the synchronous step; ``grad_norm`` sums squares in bucket order
    instead of leaf order (~1e-6 relative).  Pipelined-only.
    """
    spec = spec or coding.SchemeSpec()
    dev = resolve_device(device)
    comm = comm or make_local_comm(code.n, dev)
    n = comm.n
    workers = comm.workers
    if code.n != n:
        raise ValueError(f"code.n={code.n} != data-parallel degree {n}")
    if loss_fn is None:
        loss_fn = model_api.make_loss(cfg)
    if params_like is None:
        params_like = model_api.init(cfg, "meta")
    k_subsets = getattr(code, "num_subsets", n)
    if grad_scale is None:
        linear = cfg is not None and cfg.family == "linear"
        grad_scale = 1.0 if linear else 1.0 / k_subsets
    partial = spec.partial
    pipelined = spec.pipelined
    fuse = bool(spec.fuse_apply)
    # the spec has refused pipelined with packed=False or partial=True, and
    # with a psum schedule given by name; a Schedule object is checked here
    if pipelined and not coding.get_schedule(spec.schedule).uses_encoding:
        raise ValueError(
            "pipelined=True needs an encoding schedule (gather/a2a); the "
            "psum baseline has no wire to double-buffer")
    if fuse and optimizer.kind != "sgd":
        raise ValueError(
            f"fuse_apply supports optimizer.kind='sgd' only (the fused "
            f"kernel replicates the SGD-momentum rule); got "
            f"{optimizer.kind or 'opaque'!r}")

    codec = spec.make_codec(code, dev)
    names = list(params_like)
    # a model's leaves skip the dims the reference's layout puts on its
    # model axis, as the reference's step does at any model-axis size
    specs = coding.param_specs(params_like) if cfg is not None else None
    plans = codec.plan(params_like, specs)
    coded_frac = codec.coded_fraction(params_like, plans)
    # static layout of every coded leaf's encoding into bucketed 128-aligned
    # flat buffers; computed once here, the step then issues one collective
    # choreography + one contraction per bucket
    pplan = (codec.pack_plan(params_like, plans)
             if spec.packed and codec.schedule.uses_encoding else None)
    flat_plans = [plans[k] for k in names]
    f32 = torch.float32
    C = torch.as_tensor(code.C).to(dtype=f32, device=dev)   # (n, d, m)

    def _zero():
        return torch.zeros((), dtype=f32, device=dev)

    def _subset_grads(params, batch, i, j):
        sub = {key: v[i, j] for key, v in batch.items()}
        lval = loss_fn(params, sub)
        g = torch.autograd.grad(lval, [params[k] for k in names])
        return lval.detach(), [x.to(f32) for x in g]

    def _scaled_with_norm(grads):
        # in place: every leaf is a buffer of this step's own (a decoded,
        # unpacked or summed gradient), and a second copy of a full model's
        # gradient would raise the step's peak memory by as much
        for g_ in grads.values():
            g_.mul_(grad_scale)
        return grads, torch.sqrt(sum(torch.sum(g_ * g_)
                                     for g_ in grads.values()))

    def _finish(grads, loss_rows, mask, gss_rows, ef, coded):
        grads, gnorm = _scaled_with_norm(grads)
        # responders' view, normalised by the subset count (= n uniformly)
        loss_global = (comm.psum(stack_rows(loss_rows, (), f32, dev)
                                 * comm.rows(mask)) / k_subsets)
        metrics = {"loss": loss_global, "grad_norm": gnorm}
        if partial and coded:
            metrics["decode_err_bound"] = ef * torch.sqrt(
                comm.psum(stack_rows(gss_rows, (), f32, dev)))
        elif partial:
            # the psum baseline carries no code: rho already drops uncovered
            # subsets exactly, so the certificate term is identically zero
            metrics["decode_err_bound"] = _zero()
        return grads, metrics

    def aggregate(params, batch, W, mask, rho, err_factor=None):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        worker_enc, loss_rows, gss_rows = [], [], []
        # packed: each worker's coded encodings are packed into its row of
        # the (w, L) bucket buffers and dropped, so no more than one
        # worker's encodings and one copy of the wire are alive at once
        bufs = (codec.wire_rows(pplan, len(workers)) if pplan is not None
                else None)
        for row, i in enumerate(workers):
            enc = [codec.encoding_zero(params[k], pl)
                   for k, pl in zip(names, flat_plans)]
            loss_acc, gss_acc = _zero(), _zero()
            for j in range(code.d):
                lval, g = _subset_grads(p, batch, i, j)
                cj, rj = C[i, j], rho[i, j]
                for t, (gleaf, pl) in enumerate(zip(g, flat_plans)):
                    contrib = (codec.encode_leaf(gleaf, cj, pl) if pl.coded
                               else rj * gleaf)
                    enc[t] = enc[t] + contrib
                loss_acc = loss_acc + rj * lval
                if partial:
                    # rho-weighted subset gradient sumsq: summed over the
                    # workers it becomes sum_j ||g_j||^2 over covered
                    # subsets — the certificate's gradient-norm term
                    gss = sum(torch.sum(torch.square(x)) for x in g)
                    gss_acc = gss_acc + rj * gss
                # one subset's gradients alive at a time: these would
                # otherwise live on through the next subset's backward
                del g, gleaf, contrib
            # stragglers transmit nothing — zero the payload
            if bufs is not None:
                wire = [codec.to_wire(e, mask[i]) if pl.coded else None
                        for e, pl in zip(enc, flat_plans)]
                for buf, packed in zip(bufs, codec.pack(wire, pplan)):
                    buf[row] = packed
                del wire
                worker_enc.append([None if pl.coded else e
                                   for e, pl in zip(enc, flat_plans)])
            else:
                worker_enc.append([codec.to_wire(e, mask[i]) if pl.coded
                                   else e for e, pl in zip(enc, flat_plans)])
            del enc
            loss_rows.append(loss_acc)
            gss_rows.append(gss_acc)

        def stacked(t):
            if worker_enc:
                return torch.stack([we[t] for we in worker_enc])
            # a rank with no worker: no rows of what a worker would send
            z = codec.encoding_zero(params[names[t]], flat_plans[t])
            if flat_plans[t].coded:
                z = codec.to_wire(z, mask[0])
            return z[None][:0]

        flat_grads: list = [None] * len(names)
        if pplan is not None:
            # packed path: coded leaves ride the plan's flat buckets (one
            # collective + one (n, L) contraction each; a bucket's wire is
            # dropped once decoded, the decoded buffers once unpacked); the
            # psum-fallback leaves are summed through a single concatenated
            # all-reduce
            decs = []
            while bufs:
                decs.append(codec.decode_packed(bufs.pop(0), W, comm))
            small = [None if pl.coded else stacked(t)
                     for t, pl in enumerate(flat_plans)]
            unpacked = codec.unpack(decs, pplan)
            del decs
            for t, g_ in (unpacked | coding.psum_fallback(small, flat_plans,
                                                          comm)).items():
                flat_grads[t] = g_
        else:
            for t, pl in enumerate(flat_plans):
                flat_grads[t] = (codec.decode_leaf(stacked(t), W, pl, comm)
                                 if pl.coded else comm.psum(stacked(t)))
        return _finish(dict(zip(names, flat_grads)), loss_rows, mask,
                       gss_rows, err_factor, coded=True)

    # psum baseline: plain rho-weighted all-reduce (uncoded / straggler-aware)
    def aggregate_psum(params, batch, W, mask, rho, err_factor=None):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        worker_acc, loss_rows = [], []
        for i in workers:
            acc = [torch.zeros(tuple(params[k].shape), dtype=f32, device=dev)
                   for k in names]
            loss_acc = _zero()
            for j in range(code.d):
                lval, g = _subset_grads(p, batch, i, j)
                rj = rho[i, j]
                acc = [a + rj * g_ for a, g_ in zip(acc, g)]
                loss_acc = loss_acc + rj * lval
                del g              # one subset's gradients alive at a time
            worker_acc.append(acc)
            loss_rows.append(loss_acc)
        grads = {k: comm.psum(stack_rows([wa[t] for wa in worker_acc],
                                         tuple(params[k].shape), f32, dev))
                 for t, k in enumerate(names)}
        return _finish(grads, loss_rows, mask, None, err_factor, coded=False)

    agg = aggregate if codec.schedule.uses_encoding else aggregate_psum

    def step(params, opt_state, batch, W, mask, rho, err_factor=None):
        grads, metrics = agg(params, batch, W, mask, rho, err_factor)
        with torch.no_grad():
            new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, metrics

    def _make_pipeline() -> PipelineFns:
        """The fill / steady / drain callables of the pipelined step.

        Wire state: one (w, L_b) buffer per bucket in the wire dtype, then
        the (w, S) f32 side buffer, a row for each of this process's ``w``
        workers: its psum-fallback leaves (flattened, in leaf order) and,
        last, its masked loss.  Every phase repeats the synchronous step's
        operations on the same values in the same order, so fill + drain
        is the synchronous step bit for bit.
        """
        slot_items = [(bi, s) for bi, b in enumerate(pplan.buckets)
                      for s in b.slots]
        small_ix = [t for t, pl in enumerate(flat_plans) if not pl.coded]
        small_shapes = [tuple(params_like[names[t]].shape) for t in small_ix]
        side_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def _encode_wire(params, batch, mask, rho):
            """One batch's backward + fused encode: per worker, fold each
            subset gradient straight into the f32 bucket accumulators (the
            synchronous fold -> to_wire -> pack without the materialised
            per-leaf encodings; the add order per element is the same and
            the padding stays exactly zero) and the rho-weighted small
            leaves."""
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
            small_rows, loss_rows = [], []
            # each worker's wire is its row of one (w, L) buffer per bucket:
            # an f32 wire is folded into in place, another type is folded
            # into an f32 accumulator and cast into the row
            wires = codec.wire_rows(pplan, len(workers))
            in_place = codec.wire_dtype == f32
            for row, i in enumerate(workers):
                accs = ([w[row] for w in wires] if in_place
                        else codec.bucket_acc_zeros(pplan))
                smalls = [torch.zeros(sh, dtype=f32, device=dev)
                          for sh in small_shapes]
                loss_acc = _zero()
                for j in range(code.d):
                    lval, g = _subset_grads(p, batch, i, j)
                    cj, rj = C[i, j], rho[i, j]
                    for bi, slot in slot_items:
                        codec.encode_into(accs[bi], g[slot.leaf_index], cj,
                                          slot)
                    smalls = [sm + rj * g[t]
                              for sm, t in zip(smalls, small_ix)]
                    loss_acc = loss_acc + rj * lval
                    del g          # one subset's gradients alive at a time
                # stragglers transmit nothing: zero the payload (in place,
                # the same product as to_wire's)
                for w, a in zip(wires, accs):
                    if in_place:
                        a.mul_(mask[i])
                    else:
                        w[row] = codec.to_wire(a, mask[i])
                del accs
                small_rows.append(smalls)
                loss_rows.append(loss_acc)
            cols = [stack_rows([r[q] for r in small_rows], sh, f32, dev)
                    .reshape(len(workers), -1)
                    for q, sh in enumerate(small_shapes)]
            loss_col = (stack_rows(loss_rows, (), f32, dev)
                        * comm.rows(mask))[:, None]
            side = torch.cat(cols + [loss_col], dim=1)
            return (*wires, side)

        def _decode_update(params, opt_state, W, wires, side):
            """Decode the in-flight wire and side buffers and apply the
            update: the synchronous step's decode and optimizer phases on
            state instead of freshly produced encodings.  The side buffer's
            two parts are summed apart, as the synchronous step sums them,
            so that each sum sees the same operand shape (a reduction's
            order may depend on it)."""
            small_grads = {}
            if small_ix:
                ssum = comm.psum(side[:, :-1].contiguous())
                off = 0
                for t, sh in zip(small_ix, small_shapes):
                    sz = math.prod(sh)
                    small_grads[t] = ssum[off:off + sz].reshape(sh)
                    off += sz
            loss = comm.psum(side[:, -1].contiguous()) / k_subsets
            if not fuse:
                decs = [codec.decode_packed(w, W, comm) for w in wires]
                flat = codec.unpack(decs, pplan) | small_grads
                grads, gnorm = _scaled_with_norm(
                    {k: flat[t] for t, k in enumerate(names)})
                with torch.no_grad():
                    new_params, new_opt = optimizer.update(grads, opt_state,
                                                           params)
                return new_params, new_opt, {"loss": loss,
                                             "grad_norm": gnorm}
            hy, mu = optimizer.hyper, opt_state["mu"]
            flat_p = [params[k] for k in names]
            flat_mu = [mu[k] for k in names]
            p_bufs, mu_bufs, ss_parts = [], [], []
            for w, pb, mb in zip(wires, codec.pack_params(flat_p, pplan),
                                 codec.pack_params(flat_mu, pplan)):
                pn, mun, ss = codec.decode_apply_packed(
                    w, W, pb, mb, comm, lr=hy["lr"],
                    momentum=hy["momentum"], scale=grad_scale)
                p_bufs.append(pn)
                mu_bufs.append(mun)
                ss_parts.append(ss)
            # each packed buffer is dropped once unpacked, before the next
            # is unpacked: one full copy of the model fewer at the peak
            del pn, mun, pb, mb
            new_p = codec.unpack_params(p_bufs, pplan, flat_p)
            del p_bufs
            new_mu = codec.unpack_params(mu_bufs, pplan, flat_mu)
            del mu_bufs
            # the small leaves ride the plain optimizer update
            small = [names[t] for t in small_ix]
            sgrads = {names[t]: small_grads[t] * grad_scale
                      for t in small_ix}
            with torch.no_grad():
                sp, sstate = optimizer.update(
                    sgrads, {"mu": {k: mu[k] for k in small}},
                    {k: params[k] for k in small})
            new_params = {k: new_p[t] if t in new_p else sp[k]
                          for t, k in enumerate(names)}
            new_opt = {"mu": {k: new_mu[t] if t in new_mu
                              else sstate["mu"][k]
                              for t, k in enumerate(names)}}
            gnorm = torch.sqrt(sum(ss_parts)
                               + sum(torch.sum(g_ * g_)
                                     for g_ in sgrads.values()))
            return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

        def fill(params, batch, mask, rho):
            """Pipeline fill: encode one batch into wire state, no update."""
            return _encode_wire(params, batch, mask, rho)

        def steady(params, opt_state, batch, W, mask, rho, *wire):
            """Decode the in-flight wire (the pattern of the PREVIOUS call:
            its W arrives now) and apply the stale-by-one update, while
            encoding the current batch at the pre-update params.  On the
            card the decode half runs on the side stream: it first waits for
            everything queued on the current stream (the wire, the params),
            and the current stream waits for it before this returns.  Every
            tensor the side stream reads is an argument of this call, alive
            until that join; what it allocates belongs to the side stream,
            which waits for the current one at the start of every call."""
            if side_stream is None:
                out = _decode_update(params, opt_state, W, wire[:-1],
                                     wire[-1])
                return out + _encode_wire(params, batch, mask, rho)
            cur = torch.cuda.current_stream(dev)
            side_stream.wait_stream(cur)
            with torch.cuda.stream(side_stream):
                out = _decode_update(params, opt_state, W, wire[:-1],
                                     wire[-1])
            new_wire = _encode_wire(params, batch, mask, rho)
            cur.wait_stream(side_stream)
            return out + new_wire

        def drain(params, opt_state, W, *wire):
            """Retire the last in-flight wire: decode + update only."""
            return _decode_update(params, opt_state, W, wire[:-1], wire[-1])

        return PipelineFns(fill=fill, steady=steady, drain=drain,
                           num_buffers=len(pplan.buckets) + 1)

    pipeline = _make_pipeline() if pipelined else None
    return StepArtifacts(step=step, aggregate=agg, plans=plans,
                         coded_fraction=coded_frac, codec=codec, comm=comm,
                         pack_plan=pplan, partial=partial, spec=spec,
                         pipelined=pipelined, fuse_apply=fuse,
                         pipeline=pipeline)
