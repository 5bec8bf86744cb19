"""Serving: prefill + KV-cache decode for batched greedy generation, and
the coded inference server.

``build_serve_artifacts`` / ``BatchedEngine`` run the model's prefill and
decode steps on one device: a prompt batch is prefilled (its attention
through the flash kernel on the card above 2048 tokens), then decoded one
token a step against the cache, greedily.  The :class:`CodedServer` is the
paper's scheme applied to inference: batched forward passes ride the coded
replica layout of ``repro_torch.serving.coded``; the engine decodes from
the fastest ``n - s`` replicas (hedging: straggler payloads never reach the
output bits) and, with a ``partial`` spec, serves past-``s`` failures under
a certified error bound.  With ``autotune=ServingPolicy(...)`` and a timed
straggler source, every served batch feeds a ``StepRecord`` to a
``ServingAutotuner``, which re-ranks the uniform (d, s, m) x schedule
family by modeled p99 under the policy's arrival process; an adopted plan
swaps code and schedule through the per-scheme artifact cache.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .. import coding
from .._device import resolve_device
from ..comm import Comm
from ..core import make_code
from ..data import CodedBatcher
from ..models import api as model_api
from ..tune.arrivals import ServingAutotuner
from ..tune.stragglers import as_straggler_source
from ..tune.telemetry import record_from_times
from .batcher import Request, RequestBatcher
from .coded import ForwardArtifacts, failed_request_rows, make_coded_forward


@dataclasses.dataclass(frozen=True)
class ServeArtifacts:
    """The serving surface for one arch x shape on one device: prefill and
    decode callables and the cache's ``{name: (shape, dtype)}``.  (The
    reference also carries the shardings its mesh needs; one device has
    none.)"""

    prefill: Callable | None
    decode: Callable
    cache_shapes: dict
    device: torch.device


def build_serve_artifacts(cfg, *, batch: int, seq_len: int, window: int = 0,
                          device: str | torch.device = "cuda"
                          ) -> ServeArtifacts:
    """Prefill and decode for one arch x shape on ``device`` (default: the
    card; raises when there is none).  ``prefill(params, {"tokens": (batch,
    S)})`` gives the last-token logits and a cache of ``seq_len`` positions
    (``min(seq_len, window)`` ring slots with a window);
    ``decode(params, cache, token)`` consumes the cache and returns it
    advanced.  Both run without autograd."""
    dev = resolve_device(device)
    pre = model_api.make_prefill(cfg, seq_len, window=window)

    def prefill(params, batch_):
        with torch.no_grad():
            return pre(params, batch_)

    return ServeArtifacts(
        prefill=prefill, decode=model_api.make_decode(cfg, window=window),
        cache_shapes=model_api.cache_spec(cfg, batch, seq_len, window=window),
        device=dev)


class BatchedEngine:
    """Batched greedy generation on one device: fixed batch slots, one
    prefill, then one decode step a token.  Where the reference takes a
    mesh, the port takes ``device`` (default: the card; raises when there is
    none); ``params`` are moved there."""

    def __init__(self, cfg, params: dict, *, batch: int, seq_len: int,
                 window: int = 0, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.arts = build_serve_artifacts(cfg, batch=batch, seq_len=seq_len,
                                          window=window, device=device)
        self.device = self.arts.device
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.batch = batch
        self.seq_len = seq_len
        self.window = window

    def generate(self, prompts, max_new: int, *,
                 on_logits: Callable[[int, torch.Tensor], None] | None = None
                 ) -> np.ndarray:
        """prompts: (batch, prompt_len) int32 -> (batch, max_new) int32
        greedy tokens, on the host.

        Tokens and positions stay on the device until the end (no host
        sync a token).  ``on_logits(t, logits)``, when given, sees the
        prefill's logits as ``t = -1`` and decode step ``t``'s (which
        consumed token ``t``) as ``t``, each a (batch, vocab) device
        tensor, as soon as the step is enqueued.
        """
        prompts = torch.as_tensor(np.asarray(prompts)).to(self.device)
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"{B} prompts for an engine of {self.batch} "
                             f"slots")
        if not self.window and P + max_new > self.seq_len:
            raise ValueError(
                f"a dense cache of {self.seq_len} positions cannot hold a "
                f"{P}-token prompt and {max_new} new tokens")
        logits, cache = self.arts.prefill(self.params, {"tokens": prompts})
        if on_logits is not None:
            on_logits(-1, logits)
        tok = torch.argmax(logits, -1).to(torch.int32)
        outs = []
        for t in range(max_new):
            outs.append(tok)
            logits, cache = self.arts.decode(self.params, cache, tok)
            if on_logits is not None:
                on_logits(t, logits)
            tok = torch.argmax(logits, -1).to(torch.int32)
        if not outs:
            return np.zeros((B, 0), np.int32)
        return torch.stack(outs, dim=1).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """The bounded-error service-level objective for degraded serving.

    Inside the design budget (``<= s`` stragglers) decode is exact and the
    SLO is trivially met.  Past it, a ``partial`` server returns the
    least-squares decode and its error certificate; a batch is within SLO
    iff the certified L2 bound stays under ``max_decode_err``.
    """

    max_decode_err: float = float("inf")


@dataclasses.dataclass(frozen=True)
class BatchResult:
    """One served batch: decoded outputs + the hedge/degradation evidence.

    ``outputs`` is ``(valid, *out_shape)`` on the host, padding rows already
    dropped; ``requests`` aligns row-for-row when the batch came through the
    request queue (empty for raw ``serve_batch`` calls).  ``stragglers`` is
    the replica set the engine did not wait for; ``failed_rows`` the request
    rows whose subset lost every holder (only possible past the design ``s``
    in partial mode).  ``wall_s`` is the coded forward's wall time, up to a
    device synchronisation on the card.
    """

    outputs: np.ndarray
    requests: tuple[Request, ...]
    stragglers: tuple[int, ...]
    err_bound: float
    within_slo: bool
    failed_rows: tuple[int, ...]
    wall_s: float


class CodedServer:
    """Batched coded-inference engine over ``n`` replicas on one device.

    One ``repro_torch.coding.SchemeSpec`` (the same object a
    ``make_coded_train_step`` call accepts) fixes the scheme, and a straggler
    source (``repro_torch.tune``) supplies each batch's straggler set: the
    engine decodes from the fastest ``n - len(stragglers)`` replicas.  Where
    the reference takes a mesh, the port takes ``device`` (default: the
    card; raises when there is none) and optionally the replica group
    ``comm``.  ``params`` must lie on ``device``.

    With ``autotune=`` a ``repro_torch.tune.ServingPolicy`` (and a timed
    straggler source) each served batch records its per-replica timings and
    measured wall to a ``ServingAutotuner``; an adopted plan swaps the code
    and schedule within the uniform family (``k = n`` is pinned, so the
    engine batch ``B = k * b`` never changes), and each scheme's artifacts
    are built once.
    """

    def __init__(self, cfg, code, params, *,
                 spec: coding.SchemeSpec | None = None,
                 batch_per_subset: int = 1,
                 straggler_source=None,
                 slo: ServeSLO | None = None,
                 autotune=None,
                 seq_len: int = 128,
                 window: int = 0,
                 device: str | torch.device = "cuda",
                 comm: Comm | None = None):
        """Bind model, code, device and scheme; artifacts are built at the
        first served batch."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.spec = spec if spec is not None else coding.SchemeSpec()
        self.slo = slo if slo is not None else ServeSLO()
        self.seq_len = seq_len
        self.window = window
        self.b = int(batch_per_subset)
        self.code = code
        self.comm = comm
        self._source = as_straggler_source(straggler_source)
        if autotune is not None and not self._source.provides_times:
            raise ValueError(
                "autotune needs per-worker timings: pass a timed "
                "straggler_source= (e.g. a repro_torch.tune."
                "ShiftedExpSampler or a replica heartbeat feed)")
        k = getattr(code, "num_subsets", code.n)
        self.batch_requests = k * self.b
        self.batcher = RequestBatcher(self.batch_requests)
        self._arts: dict[tuple, ForwardArtifacts] = {}
        self._placer = CodedBatcher(code)
        self._tuner = (ServingAutotuner(autotune, self.batch_requests)
                       if autotune is not None else None)
        self._served = 0
        self._next_id = 0

    # ---- scheme plumbing ------------------------------------------------
    def _scheme_key(self) -> tuple:
        code = self.code
        return (code.n, code.d, code.s, code.m, self.spec.schedule,
                self.spec.packed, self.spec.partial, str(self.spec.backend),
                self.spec.encode_dtype)

    @property
    def artifacts(self) -> ForwardArtifacts:
        """The active scheme's forward artifacts (built once per scheme)."""
        key = self._scheme_key()
        if key not in self._arts:
            self._arts[key] = make_coded_forward(
                self.cfg, self.code, spec=self.spec, batch_per_subset=self.b,
                seq_len=self.seq_len, window=self.window, device=self.device,
                comm=self.comm)
        return self._arts[key]

    def _apply_plan(self, plan) -> None:
        """Adopt a ranked serve plan: swap code + schedule, keep B fixed."""
        n = self.code.n
        self.code = make_code(n, plan.d, plan.s, plan.m)
        self.spec = self.spec.replace(schedule=plan.schedule)
        self._placer = CodedBatcher(self.code)

    # ---- request-queue surface -----------------------------------------
    def submit(self, payload: dict, arrival_s: float = 0.0) -> int:
        """Enqueue one request payload; returns its request id."""
        self._next_id += 1
        self.batcher.add(Request(self._next_id, payload, arrival_s))
        return self._next_id

    def step(self) -> BatchResult | None:
        """Serve one batch from the queue (None when nothing is queued)."""
        if not len(self.batcher):
            return None
        reqs, batch, valid = self.batcher.next_batch()
        res = self.serve_batch(batch, valid=valid)
        return dataclasses.replace(res, requests=tuple(reqs))

    # ---- the coded forward ---------------------------------------------
    def serve_batch(self, batch: dict, valid: int | None = None,
                    stragglers=None) -> BatchResult:
        """Run one coded forward over a ``(B, ...)`` batch dict of numpy
        arrays or tensors.

        ``stragglers`` overrides the straggler source (tests drive exact
        patterns through it); ``valid`` trims padding rows from the
        returned outputs.  The batch is moved to the device first and
        placed there, so the d-fold redundant layout never crosses the host
        link.  Per-batch telemetry feeds the serving auto-tuner when one is
        configured.
        """
        arts = self.artifacts
        code = arts.codec.code
        times = None
        if stragglers is None:
            draw = self._source.draw(self._served, code).restrict(code.n)
            stragglers, times = list(draw.stragglers), draw.times
        else:
            stragglers = list(stragglers)
        inp = arts.step_inputs(stragglers)
        on_dev = {k: torch.as_tensor(v).to(self.device)
                  for k, v in batch.items()}
        placed = self._placer.place(on_dev)
        args = (self.params, placed, inp["W"], inp["mask"], inp["rho"])
        if arts.partial:
            args = args + (inp["err_factor"],)
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = arts.step(*args)
        if on_card:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if arts.partial:
            out, bound = out
            err_bound = float(bound)
        else:
            err_bound = 0.0
        failed = tuple(failed_request_rows(code, stragglers, self.b))
        self._served += 1
        if self._tuner is not None and times is not None:
            self._tuner.record(record_from_times(
                self._served, code, self.spec.schedule, self.spec.packed,
                times, n_drop=len(stragglers), measured_step_s=wall))
            plan = self._tuner.maybe_replan(self._served)
            if plan is not None:
                self._apply_plan(plan)
        nvalid = self.batch_requests if valid is None else int(valid)
        return BatchResult(
            outputs=out[:nvalid].cpu().numpy(),
            requests=(),
            stragglers=tuple(int(i) for i in stragglers),
            err_bound=err_bound,
            within_slo=err_bound <= self.slo.max_decode_err,
            failed_rows=failed,
            wall_s=wall)
