"""Elastic cluster membership: survive worker churn while training.

The port of the reference's ``repro.elastic``:

- :mod:`repro_torch.elastic.events` — how membership changes enter a run:
  the :class:`ChurnSource` protocol, scripted :class:`MembershipTrace`
  replays, and the :class:`PoissonChurn` spot-fleet sampler (a numpy copy
  of the reference's module);
- :mod:`repro_torch.elastic.tracker` — the :class:`MembershipTracker` state
  machine (active -> suspected -> departed, with heartbeat-miss escalation
  and backoff) and the :class:`MembershipSource` adapter that feeds
  departures into every straggler draw (a copy too);
- :mod:`repro_torch.elastic.trainer` — :class:`ElasticTrainer` +
  :class:`ElasticPolicy`: the three-rung degradation ladder (forced
  straggler / partial failover -> zero-load exact re-plan -> resize with
  warm caches) and deterministic recovery, on one device whose worker
  group is rebuilt per cluster size.
"""
from .events import (EVENT_KINDS, ChurnSource, MembershipEvent,
                     MembershipTrace, NoChurn, PoissonChurn, as_churn_source)
from .tracker import (ACTIVE, DEPARTED, SUSPECTED, MembershipSource,
                      MembershipTracker)
from .trainer import ElasticPolicy, ElasticTrainer

__all__ = [
    "EVENT_KINDS",
    "ChurnSource",
    "MembershipEvent",
    "MembershipTrace",
    "NoChurn",
    "PoissonChurn",
    "as_churn_source",
    "ACTIVE",
    "SUSPECTED",
    "DEPARTED",
    "MembershipSource",
    "MembershipTracker",
    "ElasticPolicy",
    "ElasticTrainer",
]
