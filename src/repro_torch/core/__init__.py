"""Core gradient-coding library, numpy only: copies of the reference's
``repro.core`` modules, pinned against their sources by the tests.

Public API:
  GradCode, make_code, uncoded      — code constructions (poly / random,
                                      and the chebyshev / rotation kinds of
                                      ``stable``)
  HeteroCode, make_hetero_code,
  HeteroPlan, plan_hetero           — heterogeneous-load scheme family and
                                      partial-recovery decode (``hetero``)
  FractionalRepetitionCode,
  ExpanderCode, make_frc,
  make_expander, make_approx        — approximate families with certified
                                      decode from any pattern (``approx``)
  BlockCompositeCode, make_stable   — well-conditioned constructions with
                                      certified conditioning (``stable``)
  tradeoff                          — Theorem 1 feasibility helpers
  runtime_model                     — Section VI shifted-exponential model
  stability                         — Theorem 2 / condition-number machinery
"""
from . import (approx, cyclic, hetero, polynomial, random_code,
               runtime_model, stability, stable, tradeoff)
from .approx import (ExpanderCode, FractionalRepetitionCode, make_approx,
                     make_expander, make_frc)
from .hetero import HeteroCode, HeteroPlan, make_hetero_code, plan_hetero
from .schemes import GradCode, make_code, uncoded
from .stable import BlockCompositeCode, make_stable

__all__ = [
    "GradCode", "make_code", "uncoded",
    "HeteroCode", "HeteroPlan", "make_hetero_code", "plan_hetero",
    "FractionalRepetitionCode", "ExpanderCode",
    "make_frc", "make_expander", "make_approx",
    "BlockCompositeCode", "make_stable",
    "approx", "cyclic", "hetero", "polynomial", "random_code",
    "runtime_model", "stability", "stable", "tradeoff",
]
