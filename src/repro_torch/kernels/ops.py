"""Thin dispatch over the two kernels for ad-hoc use and the kernel checks,
plus the launch counters of all of them in one place.

``mode="auto"`` goes through the wrappers (the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor); ``mode="ref"`` forces the plain
version wherever the tensor lies.  The train step does not come through
here: it goes through ``repro_torch.coding.backends``.
"""
from __future__ import annotations

import torch

from .coded_decode import LAUNCHES as _DEC_LAUNCHES
from .coded_decode import coded_decode, coded_decode_plain
from .coded_encode import LAUNCHES as _ENC_LAUNCHES
from .coded_encode import coded_encode, coded_encode_plain

MODES = ("auto", "ref")


def encode(G: torch.Tensor, C: torch.Tensor, *, mode: str = "auto",
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Coded encode.  G: (d, V, m[, R]), C: (d, m) -> (V[, R])."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    fn = coded_encode_plain if mode == "ref" else coded_encode
    return fn(G, C, out_dtype=out_dtype)


def decode(F: torch.Tensor, W: torch.Tensor, *, mode: str = "auto",
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Coded decode.  F: (n, V[, R]), W: (n, m) -> (V, m[, R])."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    fn = coded_decode_plain if mode == "ref" else coded_decode
    return fn(F, W, out_dtype=out_dtype)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {**_ENC_LAUNCHES, **_DEC_LAUNCHES}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for table in (_ENC_LAUNCHES, _DEC_LAUNCHES):
        for k in table:
            table[k] = 0
