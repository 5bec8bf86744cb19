"""Core gradient-coding library, numpy only (copies of the reference's
``repro.core`` modules, pinned against their sources by the tests).

Ported so far: the polynomial and Gaussian-random constructions behind
``GradCode`` / ``make_code``, the cyclic placement, the Theorem-1 tradeoff
helpers, and ``hetero`` (whose decode-weight solves ``GradCode`` shares).
``GradCode(kind="chebyshev" | "rotation")`` lazily imports ``stable``, which
is not ported yet: those kinds raise ``ImportError`` until it is.
"""
from . import cyclic, hetero, polynomial, random_code, tradeoff
from .hetero import HeteroCode, HeteroPlan, make_hetero_code, plan_hetero
from .schemes import GradCode, make_code, uncoded

__all__ = [
    "GradCode", "make_code", "uncoded",
    "HeteroCode", "HeteroPlan", "make_hetero_code", "plan_hetero",
    "cyclic", "hetero", "polynomial", "random_code", "tradeoff",
]
