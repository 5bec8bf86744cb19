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

Checkpoints (``checkpoint_dir=``, ``checkpoint_every=``): every
``checkpoint_every`` steps the parameters and optimizer state are saved in
the reference's npz layout (``repro_torch.checkpoint``) with the model's
name, the data cursor, the seed and the scheme signature; a new trainer on
the same directory resumes from the newest readable snapshot and warns when
its seed or scheme differ, and ``skip_to_cursor`` replays a fresh data
stream to the restored batch.  A pipelined trainer saves its parameters and
state without draining, as the reference does: the update in flight is not
in the snapshot.

Not ported yet, and refused with ``NotImplementedError``: the auto-tuner
(``autotune=``) and the reference's deprecated per-lever and straggler
keyword arguments (use ``spec=`` and ``straggler_source=``).
"""
from __future__ import annotations

import json
import pathlib
import time
import warnings
from typing import Any, Iterator

import torch

from .._device import resolve_device
from ..coding import SchemeSpec, make_step_inputs
from ..checkpoint import CheckpointManager
from ..comm import Comm
from ..convert import flatten, unflatten
from ..core import GradCode
from ..data import CodedBatcher
from ..models import api as model_api
from ..optim import Optimizer
from ..tune.stragglers import as_straggler_source
from ..tune.telemetry import scheme_k, scheme_loads
from .coded_step import make_coded_train_step
from .pipeline import PipelineDriver

# keyword arguments of the reference's Trainer that are not ported yet
_LATER = {
    "autotune": "the auto-tuner (tune/) is not ported yet",
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
                 checkpoint_dir: str | None = None, checkpoint_every: int = 0,
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
        self._data_cursor = 0   # batches consumed (for trajectory resume)
        self._driver = (PipelineDriver(self.arts) if self.spec.pipelined
                        else None)
        self.checkpoint_every = checkpoint_every
        self._ckpt = None
        if checkpoint_dir:
            self._ckpt = CheckpointManager(checkpoint_dir)
            self._restore()

    # ------------------------------------------------------- checkpoints
    def _snapshot(self) -> dict:
        """Parameters and optimizer state as the reference's nested tree
        (``{"params": {"layers": {"attn": {"wq": ...}}}, "opt_state":
        {"x_prev": {...}, "lam": ...}}``), so the npz keys are its own."""
        return {"params": unflatten(self.params),
                "opt_state": {k: unflatten(v) if isinstance(v, dict) else v
                              for k, v in self.opt_state.items()}}

    def _restore(self) -> None:
        """Resume from the newest readable snapshot, if there is one."""
        restored = self._ckpt.restore_latest(self._snapshot())
        if restored is None:
            return
        state, meta = restored
        params = flatten(state["params"])
        self.params = {k: params[k] for k in self.params}
        opt_state = {}
        for k, v in self.opt_state.items():
            got = state["opt_state"][k]
            if isinstance(v, dict):
                got = flatten(got)
                got = {n: got[n] for n in v}
            opt_state[k] = got
        self.opt_state = opt_state
        self._step_count = int(meta.get("step", 0))
        # trajectory-exact resume: where the data stream was (skip_to_cursor
        # replays a fresh stream to this point) and which seed and scheme
        # wrote the snapshot; a mismatch means the resumed run diverges
        self._data_cursor = int(meta.get("data_cursor", self._step_count))
        if "seed" in meta and int(meta["seed"]) != self.seed:
            warnings.warn(
                f"checkpoint was written with seed {meta['seed']}, trainer "
                f"has seed {self.seed}: the resumed trajectory will not "
                f"match the original run", stacklevel=3)
        if ("scheme_sig" in meta
                and meta["scheme_sig"] != repr(self._scheme_sig)):
            warnings.warn(
                f"checkpoint scheme {meta['scheme_sig']} differs from the "
                f"trainer's {self._scheme_sig!r}: resuming with a different "
                f"codec changes the straggler/decode trajectory",
                stacklevel=3)

    @staticmethod
    def _code_key(code) -> tuple:
        """Hashable scheme identity (the reference's, element for element)."""
        return (type(code).__name__, code.n, code.d, code.s, code.m,
                scheme_k(code), scheme_loads(code),
                getattr(code, "kind", ""), getattr(code, "seed", 0))

    def _sig(self) -> tuple:
        """Scheme signature: the code's key and the spec's levers, in the
        reference's order."""
        spec = self.spec
        return (self._code_key(self.code), spec.schedule, spec.packed,
                bool(spec.partial), bool(spec.pipelined))

    @property
    def _scheme_sig(self) -> tuple:
        return self._sig()

    def maybe_checkpoint(self, force: bool = False) -> None:
        """Save a snapshot when checkpointing is on and the step count is a
        multiple of ``checkpoint_every`` (or ``force``)."""
        if self._ckpt is None:
            return
        if force or (self.checkpoint_every
                     and self._step_count % self.checkpoint_every == 0):
            self._ckpt.save(self._step_count, self._snapshot(),
                            {"arch": self.cfg.name,
                             "data_cursor": self._data_cursor,
                             "seed": self.seed,
                             "scheme_sig": repr(self._scheme_sig)})

    def skip_to_cursor(self, stream: Iterator, consumed: int = 0) -> Iterator:
        """Advance a data stream to the restored batch cursor.

        After a restore, ``self._data_cursor`` batches of the original run
        are already inside the parameters; a resumed run feeding a fresh
        stream must discard exactly that many, or every later step trains
        on the wrong data.  ``consumed`` says how many batches the caller
        already pulled from this stream.  Returns the stream.
        """
        for _ in range(max(0, self._data_cursor - int(consumed))):
            next(stream)
        return stream

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
        self._data_cursor += 1
        self.maybe_checkpoint()
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
