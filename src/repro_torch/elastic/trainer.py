"""`ElasticTrainer`: survive worker churn with a three-rung ladder.

The trainer subclasses :class:`repro_torch.train.Trainer` and reacts to
membership changes (from a :class:`~repro_torch.elastic.events.ChurnSource`
and/or heartbeat-miss escalation in the
:class:`~repro_torch.elastic.tracker.MembershipTracker`) with graceful
degradation, cheapest rung first, as the reference's
``repro.elastic.trainer`` does:

1. **immediate** — a departed worker is merged into every straggler draw
   (:class:`~repro_torch.elastic.tracker.MembershipSource`), so the very
   next step treats it as a straggler.  When the combined set exceeds the
   design budget ``s``, the step *fails over to partial decode*
   (:meth:`_step_partial`): the gradient is approximate but certified
   (``decode_err_bound``), and training keeps moving instead of raising.
2. **re-plan** — after ``replan_after`` departed steps the trainer swaps to
   a zero-load heterogeneous code at **unchanged n**
   (:func:`~repro_torch.core.hetero.plan_hetero` with ``departed=``): the
   hole holds no data, the surviving workers absorb its load, the straggler
   budget covers the hole plus the original noise budget, and decode is
   exact again.  The worker group, wire format and batch split are
   untouched.  With an autotuner attached this rung goes through its
   departed-aware ranking instead.
3. **resize** — after ``resize_after`` departed steps (or on a scale-up
   join), :meth:`resize` rebuilds the cluster at the new worker count:
   drain the pipelined update in flight, checkpoint, stash the outgoing
   size's generation ``(comm, artifacts, stepped signatures)``, adopt the
   target size's (``comm_factory``), and swap in the resized code.  Every
   process holds the whole parameters and optimizer state, so they stay
   where they are, bitwise and without a copy.  Returning to a size seen
   before restores its stashed generation and builds nothing;
   :meth:`prewarm` builds a size's artifacts ahead of need, so its first
   step is not fresh either.

Recovery is symmetric: when every departure heals (an explicit rejoin) the
trainer swaps back to its exact *home* scheme, whose artifacts are still
cached.  ``elastic_events`` is the reference's decision log, entry for
entry.

Across ranks (``comm=`` a ``repro_torch.comm.DistComm``): every rank builds
the same trainer from the same seeds and is given the same churn and
batches, so it walks the same ladder; a resize re-splits the new worker
count over the same process group (``make_dist_comm``, blocks of any
size, empty ones included), and the root rank alone saves the resize's
checkpoints.  Each step the group checks, before the ladder acts and
before the step decodes, that every rank made the same decision
(``Comm.check_same``): ranks that disagree raise, naming it, instead of
meeting in collectives of other shapes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from .._device import resolve_device
from ..comm import Comm, DistComm, make_dist_comm, make_local_comm
from ..core import make_code
from ..core.hetero import HeteroCode, plan_hetero
from ..train import Trainer
from .events import as_churn_source
from .tracker import MembershipSource, MembershipTracker


class _Stepped(set):
    """A size's stepped ``(signature, batch shapes)``, as ``Trainer``
    keeps them, plus the signatures :meth:`ElasticTrainer.prewarm` built:
    those count as stepped for any batch shape."""

    def __init__(self, stepped=()):
        super().__init__(stepped)
        self.prewarmed: set[tuple] = set()

    def __contains__(self, key) -> bool:
        return set.__contains__(self, key) or key[0] in self.prewarmed


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Declarative knobs of the elastic degradation ladder."""

    #: rung 1: past-budget steps decode partially instead of raising
    partial_failover: bool = True
    #: rung 2: departed steps before the zero-load re-plan (0 = disable)
    replan_after: int = 1
    #: rung 3: departed steps before resizing to ``n_alive`` (0 = never)
    resize_after: int = 0
    #: grow the cluster when join events announce new workers
    scale_up: bool = True
    #: consecutive missed heartbeats before a worker is *suspected*
    suspect_after: int = 2
    #: further consecutive misses before a suspected worker is evicted
    evict_after: int = 3
    #: eviction-threshold multiplier per prior eviction of the worker
    backoff: float = 1.0
    #: never resize below this worker count
    min_n: int = 2
    #: cluster sizes whose worker group + step artifacts to build eagerly
    #: at construction, so an anticipated resize lands warm
    prewarm: tuple[int, ...] = ()


class ElasticTrainer(Trainer):
    """A :class:`~repro_torch.train.Trainer` that survives membership churn.

    ``churn``: anything :func:`~repro_torch.elastic.events.as_churn_source`
    accepts (``None``, an event list, a ``MembershipTrace``, a
    ``PoissonChurn``); ``elastic``: the :class:`ElasticPolicy`;
    ``comm_factory``: ``n -> Comm``, the worker group of a cluster size
    (the counterpart of the reference's ``mesh_factory``; default: one
    like ``comm``, ``make_dist_comm(n, device=device)`` over the same
    process group when ``comm`` is a ``DistComm``, else
    ``make_local_comm(n, device)``).  Every other keyword goes to
    ``Trainer``; ``device`` defaults to the card and raises when there is
    none.
    """

    def __init__(self, cfg: Any, code, optimizer, *, churn: Any | None = None,
                 elastic: ElasticPolicy = ElasticPolicy(),
                 comm_factory: Callable[[int], Comm] | None = None,
                 **trainer_kwargs):
        device = resolve_device(trainer_kwargs.pop("device", "cuda"))
        self.churn = churn
        self.elastic = elastic
        comm = trainer_kwargs.pop("comm", None)
        if comm_factory is None:
            make = (make_dist_comm if isinstance(comm, DistComm)
                    else make_local_comm)
            comm_factory = functools.partial(make, device=device)
        self.comm_factory = comm_factory
        comm = comm or self.comm_factory(code.n)
        super().__init__(cfg, code, optimizer, device=device, comm=comm,
                         **trainer_kwargs)
        pol = self.elastic
        self._churn = as_churn_source(self.churn)
        self.tracker = MembershipTracker(
            self.code.n, suspect_after=pol.suspect_after,
            evict_after=pol.evict_after, backoff=pol.backoff)
        # every straggler draw now feeds membership escalation, and the
        # departed set rides along as forced stragglers (rung 1)
        self._source = MembershipSource(self.tracker, self._source)
        # the exact design scheme to restore on full recovery, plus the
        # (d, s, m) triple a resize re-instantiates at the new n
        self._home_code = self.code
        self._design = (self.code.d, self.code.s, self.code.m)
        #: per-n stash of (comm, arts_cache, seen): resize swaps whole
        #: generations, so returning to a seen n builds nothing
        self._seen = _Stepped(self._seen)
        self._comm_caches: dict[int, tuple] = {
            self.code.n: (self.comm, self._arts_cache, self._seen)}
        self._last_global_batch: int | None = None
        #: chronological ladder decisions, for benches/docs
        self.elastic_events: list[dict] = []
        for n_ in pol.prewarm:
            self.prewarm(n_)

    # ------------------------------------------------------- Trainer hooks
    def _step_partial(self, stragglers) -> bool:
        """Rung 1: force partial decode when the budget cannot cover.  The
        ranks agree on the straggler set and the failover first."""
        stragglers = tuple(int(i) for i in stragglers)
        failover = (not self.partial and self.elastic.partial_failover
                    and len(stragglers) > self.code.s)
        self.comm.check_same(
            f"the stragglers and the partial failover at step "
            f"{self._step_count}", repr((stragglers, failover)))
        if failover:
            self.elastic_events.append(
                {"step": self._step_count, "action": "partial-failover",
                 "stragglers": stragglers, "s": self.code.s})
        return self.partial or failover

    def _departed_workers(self) -> tuple[int, ...]:
        """The tracker's departed set, for the autotuner's ranking."""
        return self.tracker.departed

    def _apply_plan(self, plan) -> None:
        """Adopt a tuner plan; a ``resize_to`` plan goes through resize."""
        new_n = getattr(plan, "resize_to", None)
        if new_n:
            if not self._can_resize(new_n):
                self.elastic_events.append(
                    {"step": self._step_count, "action": "resize-skipped",
                     "to": new_n, "reason": "infeasible"})
                return
            self.resize(new_n, plan=plan)
        else:
            super()._apply_plan(plan)

    # ------------------------------------------------------------ the step
    def step(self, batch):
        """Ingest churn events, walk the ladder, then run the coded step."""
        for v in batch.values():
            self._last_global_batch = int(v.shape[0])
            break
        for ev in self._churn.events(self._step_count):
            self.tracker.apply(ev)
        self._maybe_ladder()
        return super().step(batch)

    # ------------------------------------------------------------- ladder
    def _maybe_ladder(self) -> None:
        """Rung 2/3 for this step (rung 1 lives in the draw): the decision
        is made, every rank checks that the others made the same, and only
        then is it carried out."""
        step = self._step_count
        decision = self._ladder_decision(step)
        agreed = None if decision is None else (
            *decision[:2], getattr(decision[2], "loads", None))
        self.comm.check_same(f"the elastic ladder's decision at step {step}",
                             repr(agreed))
        if decision is None:
            return
        action, arg, code = decision
        if action == "scale-up":
            self.tracker.pending_joins.clear()
            self.resize(arg, step=step)
        elif action == "resize":
            self.resize(arg, step=step)
        elif action == "recover-home":
            # full recovery: every departure healed — swap back to the exact
            # home scheme (its artifacts are still cached)
            self._swap_code(self._home_code, self.schedule, self.packed,
                            self.pipelined)
            self.elastic_events.append(
                {"step": step, "action": "recover-home", "n": self.code.n})
        else:                               # replan-degraded
            self._swap_code(code, self.schedule, self.packed, False)
            self.elastic_events.append(
                {"step": step, "action": "replan-degraded",
                 "departed": arg, "loads": code.loads, "s": code.s})

    def _ladder_decision(self, step: int) -> tuple | None:
        """What the ladder does at ``step``, without doing it: ``(action,
        argument, code)`` or None.  ``scale-up`` and ``resize`` carry the
        target size, ``replan-degraded`` the departed set and its code."""
        pol = self.elastic
        t = self.tracker
        if pol.scale_up and t.pending_joins:
            # each pending join is one worker the cluster has no slot for
            # (post-repack indices are positional, so the event's index
            # only signals "new worker", not a target size)
            new_n = t.n + len(t.pending_joins)
            if self._can_resize(new_n):
                return "scale-up", new_n, None
        dep = t.departed
        if not dep:
            return ("recover-home", self._home_code.n, None) \
                if self._degraded else None
        age = min(t.departed_for(w, step) for w in dep)
        if (pol.resize_after and age >= pol.resize_after
                and self._can_resize(t.n_alive)):
            return "resize", t.n_alive, None
        # rung 2: with a tuner attached the departed-aware ranking owns
        # this decision (it prices stay-degraded vs resize); without one,
        # re-plan directly once the departure has outlived replan_after.
        # The re-plan is synchronous, as in the reference: a later
        # recover-home keeps that lever
        if self._tuner is None and pol.replan_after and age >= pol.replan_after:
            code = self._degraded_code(dep)
            if (code is not None
                    and self._code_key(code) != self._code_key(self.code)):
                return "replan-degraded", dep, code
        return None

    @property
    def _degraded(self) -> bool:
        """True while the active code differs from the home design."""
        return self._code_key(self.code) != self._code_key(self._home_code)

    def _degraded_code(self, departed) -> HeteroCode | None:
        """Rung 2: the zero-load exact-decode code, or None if infeasible.

        The straggler budget grows to cover the hole plus the original
        noise budget, clamped by feasibility (every subset still needs
        ``s + m`` replicas on the alive workers); ``k`` stays the home
        subset count so the batch split is unchanged.
        """
        d0, s0, m0 = self._design
        n = self._home_code.n
        n_alive = n - len(departed)
        s_new = min(len(departed) + s0, n_alive - m0)
        if s_new < len(departed):
            return None
        speeds = [1.0] * n
        if self._tuner is not None and self._tuner.last_fit is not None \
                and len(self._tuner.last_fit.speeds) == n:
            speeds = [float(x) for x in self._tuner.last_fit.speeds]
        try:
            plan = plan_hetero(speeds, s_new, m0,
                               k=getattr(self._home_code, "num_subsets", n),
                               departed=departed)
        except ValueError:
            return None
        return HeteroCode(plan=plan, kind="poly" if n <= 20 else "random")

    # ------------------------------------------------------------- resize
    def _resized_code(self, new_n: int):
        """The home design ``(d, s, m)`` re-instantiated at ``new_n``
        workers (deterministic: a resize back to the original size yields
        a bitwise-identical code)."""
        d0, s0, m0 = self._design
        return make_code(new_n, d0, s0, m0)

    def _can_resize(self, new_n: int) -> bool:
        """Feasibility of a resize: size floor, code, and batch split."""
        _, s0, m0 = self._design
        if new_n < max(self.elastic.min_n, s0 + m0) or new_n == self.code.n:
            return False
        if (self._last_global_batch is not None
                and self._last_global_batch % new_n != 0):
            return False
        return True

    def _generation(self, n: int) -> tuple:
        """The stashed ``(comm, arts_cache, seen)`` of size ``n``, made
        empty on first use."""
        if n not in self._comm_caches:
            self._comm_caches[n] = (self.comm_factory(n), {}, _Stepped())
        return self._comm_caches[n]

    def prewarm(self, new_n: int) -> bool:
        """Build the worker group and the step artifacts of a future size.

        The build goes through ``_get_arts`` under the target size's
        generation (its key, and its rule that a synchronous build drops
        ``fuse_apply``), so a later :meth:`resize` to that size finds the
        artifacts and builds nothing.  Nothing is compiled at a first step
        in the port, so the prewarmed signature counts as stepped for any
        batch shape: that first step is not fresh.  Returns False when
        the size is infeasible for the home design.
        """
        _, s0, m0 = self._design
        if new_n < s0 + m0 or new_n == self.code.n:
            return False
        own = (self.comm, self._arts_cache, self._seen)
        self.comm, self._arts_cache, self._seen = self._generation(new_n)
        try:
            code = self._resized_code(new_n)
            self._get_arts(code, self.schedule, self.packed, False)
            self._seen.prewarmed.add((self._code_key(code), self.schedule,
                                      self.packed, self.partial, False))
        finally:
            self.comm, self._arts_cache, self._seen = own
        self.elastic_events.append(
            {"step": self._step_count, "action": "prewarm", "n": new_n})
        return True

    def resize(self, new_n: int, step: int | None = None, plan=None) -> None:
        """Rung 3: rebuild the cluster at ``new_n`` workers.

        Drains the pipelined update in flight, checkpoints, stashes the
        outgoing size's generation, adopts the target size's (stashed if
        the size was seen or prewarmed), and swaps to the resized code —
        ``plan`` (a tuner plan with ``resize_to``) overrides the default
        home-design re-instantiation.  The parameters and optimizer state
        stay on the device untouched.  The tracker is repacked: alive
        workers renumber to ``0..new_n-1``.
        """
        step = self._step_count if step is None else step
        if new_n == self.code.n:
            return
        code = (self._code_for_plan(plan) if plan is not None
                else self._resized_code(new_n))
        if self._driver is not None and self._driver.in_flight:
            self.params, self.opt_state, _ = self._driver.drain(
                self.params, self.opt_state)
        self._driver = None
        self.maybe_checkpoint(force=True)
        # stash the outgoing generation, adopt (or create) the target's
        self._comm_caches[self.code.n] = (self.comm, self._arts_cache,
                                          self._seen)
        self.comm, self._arts_cache, self._seen = self._generation(new_n)
        schedule = plan.schedule if plan is not None else self.schedule
        packed = plan.packed if plan is not None else self.packed
        pipelined = (getattr(plan, "pipelined", False) if plan is not None
                     else self.pipelined)
        self._swap_code(code, schedule, packed, pipelined)
        self._home_code = code if plan is None else self._resized_code(new_n)
        self.tracker.resize(new_n, step)
        self.tracker.reactivate_all(step)
        # read after the swap, as the reference reads it: the target's
        # cache then holds at least the artifacts just adopted
        self.elastic_events.append(
            {"step": step, "action": "resize", "n": new_n,
             "warm": bool(self._arts_cache)})
        self.maybe_checkpoint(force=True)
