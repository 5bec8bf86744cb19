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

Auto-tuning (``autotune=AutotunePolicy(...)``, with a timed straggler
source such as ``repro_torch.tune.DriftingSampler``): every step records a
``StepRecord`` (per-worker compute and communication durations, the induced
straggler set, the measured step wall) and every ``policy.interval`` steps
the tuner refits the Section-VI shifted-exponential model and re-ranks the
(d, s, m) x schedule x family space (``repro_torch.tune``).  An adopted plan
swaps code, schedule, wire and batcher in place; the step artifacts are
cached by scheme signature, so returning to a scheme rebuilds nothing.  A
pipelined swap first drains the update in flight under the outgoing codec.
The first step under a signature not seen before stands in for the
reference's freshly compiled executable: its wall calibrates the recompile
charge (``compile_s``), not the step cost.

Across ranks (``comm=`` a ``repro_torch.comm.DistComm``): every rank builds
the same trainer from the same seeds (the code, the float64 solve for
``W``, the straggler draws and the batch are host-side and alike), computes
its own workers' subsets and applies the same update, so the parameters
stay replicated.  The decisions that would otherwise differ by rank are
made once for all of them: the tuner records the slowest rank's wall
(``Comm.step_wall``), so every rank adopts the same plan at the same step,
and the group checks after each step, before adopting it, that every rank
holds that plan (``Comm.check_same``);
only the root rank writes a snapshot, and every rank waits for it
(``Comm.barrier``); every rank restores the newest snapshot, and the group
checks that they restored the same step.

Refused with ``NotImplementedError``: the reference's deprecated per-lever
and straggler keyword arguments (use ``spec=`` and ``straggler_source=``).
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
from ..core import (BlockCompositeCode, ExpanderCode,
                    FractionalRepetitionCode, GradCode, HeteroCode, HeteroPlan,
                    make_approx, make_code, make_stable)
from ..data import CodedBatcher
from ..models import api as model_api
from ..optim import Optimizer
from ..tune.planner import Plan
from ..tune.policy import Autotuner
from ..tune.stragglers import as_straggler_source
from ..tune.telemetry import (TelemetryLog, record_from_times, scheme_k,
                              scheme_loads)
from .coded_step import make_coded_train_step
from .pipeline import PipelineDriver

# keyword arguments of the reference's Trainer that the port refuses
_LATER = {
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
                 straggler_source: Any | None = None,
                 autotune: Any | None = None, seed: int = 0,
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
        self._fuse = self.spec.fuse_apply   # kept for pipelined schemes
        self.seed = seed
        self.device = resolve_device(device)
        self.comm = comm
        self._source = as_straggler_source(straggler_source)
        if autotune is not None and not self._source.provides_times:
            raise ValueError(
                "autotune needs per-worker timings: pass a timed "
                "straggler_source= (e.g. a repro_torch.tune."
                "ShiftedExpSampler or a cluster heartbeat feed)")
        self._arts_cache: dict[tuple, Any] = {}
        self._seen: set[tuple] = set()   # (signature, batch shapes) stepped
        self.arts = self._get_arts(code, self.schedule, self.packed,
                                   self.pipelined)
        self._driver: PipelineDriver | None = None
        self.batcher = CodedBatcher(code)
        # drawn where the parameters live: a full-width model is made on
        # the card without a pass through the host
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = model_api.init(cfg, self.device, gen)
        self.opt_state = optimizer.init(self.params)
        self._step_count = 0
        self._data_cursor = 0   # batches consumed (for trajectory resume)
        self._tuner = None
        self.telemetry = None
        if autotune is not None:
            self._tuner = Autotuner(autotune, current=self._current_plan())
            self.telemetry = self._tuner.telemetry
        elif self._source.provides_times:
            self.telemetry = TelemetryLog()
        self.checkpoint_every = checkpoint_every
        self._ckpt = None
        if checkpoint_dir:
            self._ckpt = CheckpointManager(checkpoint_dir)
            self._restore()

    # the active scheme's levers (the auto-tuner swaps them through spec)
    @property
    def schedule(self) -> str:
        return self.spec.schedule

    @property
    def packed(self) -> bool:
        return self.spec.packed

    @property
    def partial(self) -> bool:
        return bool(self.spec.partial)

    @property
    def pipelined(self) -> bool:
        return bool(self.spec.pipelined)

    # ------------------------------------------------------- checkpoints
    def _snapshot(self) -> dict:
        """Parameters and optimizer state as the reference's nested tree
        (``{"params": {"layers": {"attn": {"wq": ...}}}, "opt_state":
        {"x_prev": {...}, "lam": ...}}``), so the npz keys are its own."""
        return {"params": unflatten(self.params),
                "opt_state": {k: unflatten(v) if isinstance(v, dict) else v
                              for k, v in self.opt_state.items()}}

    def _restore(self) -> None:
        """Resume from the newest readable snapshot, if there is one; every
        rank of a group restores, and the group raises unless they all
        restored the same step."""
        restored = self._ckpt.restore_latest(self._snapshot())
        self.arts.comm.check_same(
            "the restored checkpoint step",
            "none" if restored is None else str(restored[1].get("step", 0)))
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

    def _sig(self, partial: bool | None = None,
             pipelined: bool | None = None) -> tuple:
        """Scheme signature with optional per-step overrides: the code's key
        and the spec's levers, in the reference's order."""
        return (self._code_key(self.code), self.schedule, self.packed,
                self.partial if partial is None else bool(partial),
                self.pipelined if pipelined is None else bool(pipelined))

    @property
    def _scheme_sig(self) -> tuple:
        return self._sig()

    # ------------------------------------------------------- codec swapping
    def _get_arts(self, code, schedule: str, packed: bool,
                  pipelined: bool = False, partial: bool | None = None):
        """Step artifacts for a scheme, built once per signature.

        ``partial`` overrides the trainer's mode for this build (a
        past-budget step of a subclass decodes approximately instead of
        raising); partial artifacts are always synchronous.  A synchronous
        build drops ``fuse_apply``, a lever of the pipelined step only.
        """
        part = self.partial if partial is None else bool(partial)
        key = (self._code_key(code), schedule, packed, part, pipelined)
        if key not in self._arts_cache:
            spec = self.spec.replace(
                schedule=schedule, packed=packed, pipelined=pipelined,
                partial=part,
                fuse_apply=self._fuse if pipelined else None)
            self._arts_cache[key] = make_coded_train_step(
                self.cfg, code, self.optimizer, spec=spec,
                device=self.device, comm=self.comm)
        return self._arts_cache[key]

    def _current_plan(self):
        """The active scheme as a ``repro_torch.tune.Plan`` (the seed for
        the tuner's hysteresis)."""
        k = scheme_k(self.code)
        loads = scheme_loads(self.code)
        n0 = None
        if isinstance(self.code, FractionalRepetitionCode):
            fam = "frc"
        elif isinstance(self.code, ExpanderCode):
            fam = "expander"
        elif isinstance(self.code, BlockCompositeCode):
            fam = "block"
            n0 = self.code.n0
        elif getattr(self.code, "kind", "") in ("chebyshev", "rotation"):
            fam = self.code.kind
        else:
            fam = ("uniform" if k == self.code.n and len(set(loads)) == 1
                   else "hetero")
        return Plan(family=fam, d=self.code.d, s=self.code.s, m=self.code.m,
                    k=k, loads=loads, schedule=self.schedule,
                    packed=self.packed, predicted_wait_s=0.0,
                    predicted_step_s=0.0, predicted_total_s=0.0,
                    pipelined=self.pipelined, n0=n0)

    def _code_for_plan(self, plan):
        """Materialise the scheme object a ranked plan selects."""
        n = len(plan.loads)
        if plan.family == "uniform":
            return make_code(n, plan.d, plan.s, plan.m)
        if plan.family in ("frc", "expander"):
            # both approx families use d = m * replication; the expander
            # graph seed is the planner's default (0), so the graph built
            # is the one that was ranked
            return make_approx(plan.family, n, plan.d // plan.m, plan.m)
        if plan.family in ("chebyshev", "rotation", "block"):
            # (family, d, s, m) and a block plan's tile size n0 fix the
            # code; the rotation seed is the planner's default (0)
            return make_stable(plan.family, n, plan.d, plan.s, plan.m,
                               n0=plan.n0)
        # hetero plans carry their exact load assignment (elastic zero-load
        # holes included): build the code from those loads
        speeds = ((1.0,) * n if self._tuner is None
                  or self._tuner.last_fit is None
                  or len(self._tuner.last_fit.speeds) != n
                  else tuple(float(x) for x in self._tuner.last_fit.speeds))
        hp = HeteroPlan(n=n, s=plan.s, m=plan.m, k=plan.k,
                        speeds=speeds, loads=tuple(plan.loads))
        return HeteroCode(plan=hp, kind="poly" if n <= 20 else "random")

    def _swap_code(self, code, schedule: str, packed: bool,
                   pipelined: bool) -> None:
        """Swap the active codec in place (code, schedule, wire, batcher).

        A pipelined swap first drains the wire in flight (encoded under the
        outgoing scheme's pack plan, which the incoming one cannot decode),
        applying the pending gradient before the new codec takes over."""
        if self._driver is not None and self._driver.in_flight:
            self.params, self.opt_state, _ = self._driver.drain(
                self.params, self.opt_state)
        self._driver = None
        self.code = code
        self.spec = self.spec.replace(
            schedule=schedule, packed=packed, pipelined=pipelined,
            fuse_apply=self._fuse if pipelined else None)
        self.arts = self._get_arts(code, schedule, packed, pipelined)
        self.batcher = CodedBatcher(code)

    def _apply_plan(self, plan) -> None:
        """Adopt a ranked plan: materialise its code and swap it in.

        An approx plan whose drop budget exceeds the code's structural
        tolerance (``plan.s > code.s``) flips the trainer to partial mode:
        the step decodes a certified estimate instead of raising past
        ``s``.
        """
        code = self._code_for_plan(plan)
        if plan.family in ("frc", "expander") and plan.s > code.s:
            # approx plans are never pipelined (partial + pipelined is
            # refused by the spec)
            self.spec = self.spec.replace(partial=True, pipelined=False,
                                          fuse_apply=None)
        self._swap_code(code, plan.schedule, plan.packed, plan.pipelined)

    @property
    def autotune_events(self) -> list[dict]:
        """The tuner's decision log (empty when autotune is off)."""
        return [] if self._tuner is None else self._tuner.events

    @property
    def cached_schemes(self) -> int:
        """Number of distinct scheme signatures with built step artifacts
        (revisiting a scheme does not rebuild)."""
        return len(self._arts_cache)

    def maybe_checkpoint(self, force: bool = False) -> None:
        """Save a snapshot when checkpointing is on and the step count is a
        multiple of ``checkpoint_every`` (or ``force``).  In a group of
        ranks the root writes it (and prunes the old ones) and every rank
        waits until it is on disk."""
        if self._ckpt is None:
            return
        if not (force or (self.checkpoint_every
                          and self._step_count % self.checkpoint_every == 0)):
            return
        group = self.arts.comm
        if group.is_root:
            self._ckpt.save(self._step_count, self._snapshot(),
                            {"arch": self.cfg.name,
                             "data_cursor": self._data_cursor,
                             "seed": self.seed,
                             "scheme_sig": repr(self._scheme_sig)})
        group.barrier()

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

    # ---------------------------------------------------------------- hooks
    def _step_partial(self, stragglers) -> bool:
        """Whether this step decodes partially (a subclass's failover hook:
        an elastic trainer forces ``True`` past the design budget ``s``)."""
        return bool(self.partial)

    def _departed_workers(self) -> tuple[int, ...]:
        """Departed worker indices for the re-planner (subclass hook)."""
        return ()

    # ---------------------------------------------------------------- steps
    def step(self, batch: dict) -> dict[str, float]:
        """One coded step on a global batch ``{name: (global_batch, ...)}``
        of numpy arrays or tensors.  The batch is moved to the device first
        and placed there, so the d-fold redundant layout never crosses the
        host link.

        Pipelined: the first call fills the pipeline and reports NaN
        ``loss`` / ``grad_norm`` (no update retired yet); every later call's
        metrics describe the previous batch, whose gradient it applied.
        A step that decodes partially runs synchronously, after draining
        the update in flight.  With a timed straggler source the metrics
        also carry ``modeled_wait_s`` and the step feeds the telemetry (and
        the tuner, which may swap the codec after it)."""
        on_dev = {k: torch.as_tensor(v).to(self.device)
                  for k, v in batch.items()}
        placed = self.batcher.place(on_dev)
        draw = self._source.draw(self._step_count,
                                 self.code).restrict(self.code.n)
        stragglers = list(draw.stragglers)
        part = self._step_partial(stragglers)
        pipelined = self.pipelined and not part
        if (self.pipelined and not pipelined and self._driver is not None
                and self._driver.in_flight):
            # retire the update in flight before stepping synchronously:
            # its buffers are valid under the unchanged codec
            self.params, self.opt_state, _ = self._driver.drain(
                self.params, self.opt_state)
            self._driver = None
        arts = (self.arts if part == self.partial
                and pipelined == self.pipelined
                else self._get_arts(self.code, self.schedule, self.packed,
                                    pipelined=pipelined, partial=part))
        # nothing is compiled here: the first step under a signature and
        # batch shape stands in for the reference's fresh executable
        keyshape = (self._sig(partial=part, pipelined=pipelined),
                    tuple(sorted((k, tuple(v.shape))
                                 for k, v in placed.items())))
        fresh = keyshape not in self._seen
        self._seen.add(keyshape)
        inp = make_step_inputs(self.code, stragglers, partial=part)
        args = [torch.as_tensor(inp[k]).to(self.device)
                for k in ("W", "mask", "rho") + (("err_factor",) if part
                                                 else ())]
        t0 = time.perf_counter()
        if pipelined:
            if self._driver is None:
                self._driver = PipelineDriver(arts)
            self.params, self.opt_state, metrics = self._driver.step(
                self.params, self.opt_state, placed, *args)
        else:
            self.params, self.opt_state, metrics = arts.step(
                self.params, self.opt_state, placed, *args)
        out = self._metrics(metrics, t0)
        if draw.times is not None:
            # a fresh signature's wall is kept out of the step-cost book
            # (measured_step_s 0) and prices the recompile charge instead;
            # a fill retires no update, so its wall is no step cost either.
            # The wall is the slowest rank's, so every rank's tuner sees
            # the same records
            wall = arts.comm.step_wall(out["step_time_s"])
            uncal = fresh or metrics is None
            rec = record_from_times(self._step_count, self.code,
                                    self.schedule, self.packed, draw.times,
                                    measured_step_s=0.0 if uncal else wall,
                                    pipelined=pipelined,
                                    compile_s=wall if fresh else 0.0)
            out["modeled_wait_s"] = rec.wait_s
            if self._tuner is not None:
                self._tuner.record(rec)
                new_plan = self._tuner.maybe_replan(
                    self._step_count, departed=self._departed_workers())
                # before anything changes, so that ranks that disagree
                # raise instead of meeting in mismatched collectives
                arts.comm.check_same(
                    f"the scheme plan after step {self._step_count}",
                    repr(new_plan))
                if new_plan is not None:
                    self._apply_plan(new_plan)
            else:
                self.telemetry.append(rec)
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
