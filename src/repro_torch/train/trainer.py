"""High-level training loop: wires the data pipeline, the coded step and
the straggler simulation into a run loop.

Scheme levers arrive as one ``repro_torch.coding.SchemeSpec``
(``Trainer(spec=...)``); ``SchemeSpec(pipelined=True)`` runs the async
stale-by-one step through a ``PipelineDriver``.  Stragglers: each step
draws a straggler set from the trainer's ``straggler_source`` (the
``repro_torch.tune`` protocol: ``NoStragglers`` default,
``FixedStragglers``, ``RandomStragglers`` or a timings-backed
``TimedSource``), computes the host-side float64 decode
weights for that responder pattern, and feeds them to the step.

Not ported yet, and refused with ``NotImplementedError``: the auto-tuner
(``autotune=``), checkpointing (``checkpoint_dir=``, ``checkpoint_every=``)
and the reference's deprecated per-lever and straggler keyword arguments
(use ``spec=`` and ``straggler_source=``).
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Iterator

import torch

from .._device import resolve_device
from ..coding import SchemeSpec, make_step_inputs
from ..comm import Comm
from ..core import GradCode
from ..data import CodedBatcher
from ..models import api as model_api
from ..optim import Optimizer
from ..tune.stragglers import as_straggler_source
from .coded_step import make_coded_train_step
from .pipeline import PipelineDriver

# keyword arguments of the reference's Trainer that are not ported yet
_LATER = {
    "autotune": "the auto-tuner (tune/) is not ported yet",
    "checkpoint_dir": "checkpointing (checkpoint/store.py) is not ported yet",
    "checkpoint_every": "checkpointing (checkpoint/store.py) is not ported yet",
    "pipelined": "deprecated in the reference; pass "
                 "spec=SchemeSpec(pipelined=True)",
    "schedule": "deprecated in the reference; pass spec=SchemeSpec(...)",
    "backend": "deprecated in the reference; pass spec=SchemeSpec(...)",
    "packed": "deprecated in the reference; pass spec=SchemeSpec(...)",
    "partial": "deprecated in the reference; pass spec=SchemeSpec(...)",
    "straggler_mode": "deprecated in the reference; pass straggler_source=",
    "fixed_stragglers": "deprecated in the reference; pass straggler_source=",
    "injector": "deprecated in the reference; pass straggler_source=",
}


class Trainer:
    """Coded training loop on one device (default: the card; raises when
    there is none — pass ``device="cpu"`` for the host)."""

    def __init__(self, cfg: Any, code: GradCode, optimizer: Optimizer, *,
                 spec: SchemeSpec | None = None,
                 straggler_source: Any | None = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 comm: Comm | None = None, **later):
        for k in later:
            if k not in _LATER:
                raise TypeError(f"Trainer got an unexpected keyword "
                                f"argument {k!r}")
            raise NotImplementedError(f"Trainer({k}=...): {_LATER[k]}")
        self.cfg = cfg
        self.code = code
        self.optimizer = optimizer
        self.spec = spec or SchemeSpec()
        self.seed = seed
        self.device = resolve_device(device)
        self._source = as_straggler_source(straggler_source)
        self.arts = make_coded_train_step(cfg, code, optimizer,
                                          spec=self.spec, device=self.device,
                                          comm=comm)
        self.batcher = CodedBatcher(code)
        # drawn where the parameters live: a full-width model is made on
        # the card without a pass through the host
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = model_api.init(cfg, self.device, gen)
        self.opt_state = optimizer.init(self.params)
        self._step_count = 0
        self._driver = (PipelineDriver(self.arts) if self.spec.pipelined
                        else None)

    def step(self, batch: dict) -> dict[str, float]:
        """One coded step on a global batch ``{name: (global_batch, ...)}``
        of numpy arrays or tensors.  The batch is moved to the device first
        and placed there, so the d-fold redundant layout never crosses the
        host link.

        Pipelined: the first call fills the pipeline and reports NaN
        ``loss`` / ``grad_norm`` (no update retired yet); every later call's
        metrics describe the previous batch, whose gradient it applied."""
        on_dev = {k: torch.as_tensor(v).to(self.device)
                  for k, v in batch.items()}
        placed = self.batcher.place(on_dev)
        draw = self._source.draw(self._step_count,
                                 self.code).restrict(self.code.n)
        part = bool(self.spec.partial)
        inp = make_step_inputs(self.code, list(draw.stragglers), partial=part)
        args = [torch.as_tensor(inp[k]).to(self.device)
                for k in ("W", "mask", "rho") + (("err_factor",) if part
                                                 else ())]
        t0 = time.perf_counter()
        if self._driver is not None:
            self.params, self.opt_state, metrics = self._driver.step(
                self.params, self.opt_state, placed, *args)
        else:
            self.params, self.opt_state, metrics = self.arts.step(
                self.params, self.opt_state, placed, *args)
        out = self._metrics(metrics, t0)
        self._step_count += 1
        return out

    def drain(self) -> dict[str, float] | None:
        """Retire the pipelined step's in-flight update (decode + apply the
        last encoded batch); returns that batch's metrics, or None when
        nothing is in flight (or the trainer is synchronous)."""
        if self._driver is None or not self._driver.in_flight:
            return None
        t0 = time.perf_counter()
        self.params, self.opt_state, metrics = self._driver.drain(
            self.params, self.opt_state)
        return self._metrics(metrics, t0)

    @staticmethod
    def _metrics(metrics, t0: float) -> dict[str, float]:
        out = ({"loss": float("nan"), "grad_norm": float("nan")}
               if metrics is None
               else {k: float(v) for k, v in metrics.items()})  # waits
        out["step_time_s"] = time.perf_counter() - t0
        return out

    def run(self, stream: Iterator[dict], steps: int, log_every: int = 10,
            log_path: str | None = None) -> list[dict]:
        """``steps`` steps over ``stream``; returns the per-step metrics."""
        logs = []
        t0 = time.time()
        for i in range(steps):
            m = self.step(next(stream))
            m["step"] = i
            m["wall"] = time.time() - t0
            logs.append(m)
            if log_every and i % log_every == 0:
                print(f"step {i:5d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3e} t {m['wall']:.1f}s")
        if log_path:
            pathlib.Path(log_path).write_text(json.dumps(logs))
        return logs
