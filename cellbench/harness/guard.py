"""The check that no module of JAX, Flax or the JAX package is loaded.

Names are compared whole by their top-level part (before the first dot), so
``repro_torch`` is not ``repro``.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
