"""The coded train step: the paper's gradient coding wired into a generic
train step usable with any parameter dict and any loss function.

Layout: the batch arrives in the redundant coded layout (n, d, b, ...) —
dim 0 the worker, dim 1 the worker's d assigned subsets.  The ``n`` workers
live in one process on one device (``repro_torch.comm``), so the step walks
them in a Python loop where the reference runs a ``shard_map``:

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
     wire buffers (default; ``packed=False`` keeps the per-leaf escape
     hatch) and decode the summed gradient with the host-computed float64
     weights W (zero rows at stragglers) via the gather or a2a schedule —
     one collective choreography + one contraction per bucket.  Every
     reference worker decodes the same gathered stack; the single-process
     group decodes it once per bucket,
  5. run the optimizer update.

All coding phases are delegated to a ``repro_torch.coding.Codec``:
``schedule`` picks the choreography (gather / a2a / psum), ``backend`` the
encode/decode implementation ("auto" -> the CUDA kernels on a cuda device,
the plain versions on the cpu).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from .. import coding
from .._device import resolve_device
from ..comm import Comm, make_local_comm
from ..core import GradCode
from ..models import api as model_api
from ..optim import Optimizer

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

    def step_inputs(self, stragglers=()) -> dict[str, torch.Tensor]:
        """Drop-pattern hook: `W`/`mask`/`rho` on the step's device for a
        straggler set (the host-side float64 solve for this responder
        pattern).  On a partial-recovery step the dict also carries the
        pattern's ``err_factor`` certificate scalar."""
        inp = coding.make_step_inputs(self.codec.code, stragglers,
                                      partial=self.partial)
        return {k: torch.as_tensor(v).to(self.codec.device)
                for k, v in inp.items()}


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
    ``code.n`` workers on ``device``).
    """
    spec = spec or coding.SchemeSpec()
    dev = resolve_device(device)
    comm = comm or make_local_comm(code.n, dev)
    n = comm.n
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

    codec = spec.make_codec(code, dev)
    names = list(params_like)
    plans = codec.plan(params_like)
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

    def _finish(grads, loss_rows, mask, gss_rows, ef, coded):
        grads = {k: g_ * grad_scale for k, g_ in grads.items()}
        gnorm = torch.sqrt(sum(torch.sum(g_ * g_) for g_ in grads.values()))
        # responders' view, normalised by the subset count (= n uniformly)
        loss_global = comm.psum(torch.stack(loss_rows) * mask) / k_subsets
        metrics = {"loss": loss_global, "grad_norm": gnorm}
        if partial and coded:
            metrics["decode_err_bound"] = ef * torch.sqrt(
                comm.psum(torch.stack(gss_rows)))
        elif partial:
            # the psum baseline carries no code: rho already drops uncovered
            # subsets exactly, so the certificate term is identically zero
            metrics["decode_err_bound"] = _zero()
        return grads, metrics

    def aggregate(params, batch, W, mask, rho, err_factor=None):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        worker_enc, loss_rows, gss_rows = [], [], []
        for i in range(n):
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
            # stragglers transmit nothing — zero the payload
            worker_enc.append([codec.to_wire(e, mask[i]) if pl.coded else e
                               for e, pl in zip(enc, flat_plans)])
            loss_rows.append(loss_acc)
            gss_rows.append(gss_acc)

        def stacked(t):
            return torch.stack([we[t] for we in worker_enc])

        flat_grads: list = [None] * len(names)
        if pplan is not None:
            # packed path: coded leaves ride the plan's flat buckets (one
            # collective + one (n, L) contraction each); the psum-fallback
            # leaves are summed through a single concatenated all-reduce
            bufs = [torch.stack(rows) for rows in
                    zip(*(codec.pack(we, pplan) for we in worker_enc))]
            decs = [codec.decode_packed(b, W, comm) for b in bufs]
            small = [None if pl.coded else stacked(t)
                     for t, pl in enumerate(flat_plans)]
            for t, g_ in (codec.unpack(decs, pplan)
                          | coding.psum_fallback(small, flat_plans,
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
        for i in range(n):
            acc = [torch.zeros(tuple(params[k].shape), dtype=f32, device=dev)
                   for k in names]
            loss_acc = _zero()
            for j in range(code.d):
                lval, g = _subset_grads(p, batch, i, j)
                rj = rho[i, j]
                acc = [a + rj * g_ for a, g_ in zip(acc, g)]
                loss_acc = loss_acc + rj * lval
            worker_acc.append(acc)
            loss_rows.append(loss_acc)
        grads = {k: comm.psum(torch.stack([wa[t] for wa in worker_acc]))
                 for t, k in enumerate(names)}
        return _finish(grads, loss_rows, mask, None, err_factor, coded=False)

    agg = aggregate if codec.schedule.uses_encoding else aggregate_psum

    def step(params, opt_state, batch, W, mask, rho, err_factor=None):
        grads, metrics = agg(params, batch, W, mask, rho, err_factor)
        with torch.no_grad():
            new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, metrics

    return StepArtifacts(step=step, aggregate=agg, plans=plans,
                         coded_fraction=coded_frac, codec=codec, comm=comm,
                         pack_plan=pplan, partial=partial, spec=spec)
