"""Discoverable benchmark specs.

A `BenchSpec` names a benchmark, describes it, and wraps a callable
`fn(quick: bool) -> list[BenchResult]`.  Benchmark modules register their spec
at import time; `benchmarks/run.py` imports the modules and then drives
everything through the registry, so adding a benchmark is one `register()`
call away from CLI discovery, JSON emission, and CI gating.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .result import BenchResult

BenchFn = Callable[[bool], list[BenchResult]]


@dataclasses.dataclass(frozen=True)
class BenchSpec:
    """One registered benchmark target."""

    name: str
    description: str
    fn: BenchFn
    tags: tuple[str, ...] = ()


_REGISTRY: dict[str, BenchSpec] = {}


def register(spec: BenchSpec) -> BenchSpec:
    """Idempotent per name+module-reload; re-registering a name replaces it."""
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> BenchSpec:
    """Look up one registered spec by name (KeyError lists what exists)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown bench {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def all_specs() -> list[BenchSpec]:
    """Every registered spec, sorted by name."""
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def names() -> list[str]:
    """Sorted names of every registered spec."""
    return sorted(_REGISTRY)
