"""Thin dispatch over the kernels for ad-hoc use and the kernel checks, plus
the launch counters of all of them in one place.

``mode="auto"`` goes through the wrappers (the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor); ``mode="ref"`` forces the plain
version wherever the tensor lies.  The accumulating encode and the fused
decode-apply update their operands in place under ``auto`` (as the kernels
do) and leave them untouched under ``ref``; both return the result.  The
train step does not come through here: it goes through
``repro_torch.coding.backends``.
"""
from __future__ import annotations

import torch

from .coded_decode import LAUNCHES as _DEC_LAUNCHES
from .coded_decode import (coded_decode, coded_decode_apply,
                           coded_decode_apply_plain, coded_decode_plain)
from .coded_encode import LAUNCHES as _ENC_LAUNCHES
from .coded_encode import (coded_encode, coded_encode_acc,
                           coded_encode_acc_plain, coded_encode_plain)

MODES = ("auto", "ref")


def _pick(mode: str, kernel, plain):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    return plain if mode == "ref" else kernel


def encode(G: torch.Tensor, C: torch.Tensor, *, mode: str = "auto",
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Coded encode.  G: (d, V, m[, R]), C: (d, m) -> (V[, R])."""
    return _pick(mode, coded_encode, coded_encode_plain)(
        G, C, out_dtype=out_dtype)


def decode(F: torch.Tensor, W: torch.Tensor, *, mode: str = "auto",
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Coded decode.  F: (n, V[, R]), W: (n, m) -> (V, m[, R])."""
    return _pick(mode, coded_decode, coded_decode_plain)(
        F, W, out_dtype=out_dtype)


def encode_acc(acc: torch.Tensor, G: torch.Tensor, C: torch.Tensor, *,
               mode: str = "auto") -> torch.Tensor:
    """Accumulating encode ``acc + encode(G, C)``; acc (V[, R]) f32."""
    return _pick(mode, coded_encode_acc, coded_encode_acc_plain)(acc, G, C)


def decode_apply(F: torch.Tensor, W: torch.Tensor, P: torch.Tensor,
                 MU: torch.Tensor, *, lr: float, momentum: float,
                 scale: float, mode: str = "auto"):
    """Fused decode + SGD-momentum over one bucket -> (p', mu', Σg²)."""
    return _pick(mode, coded_decode_apply, coded_decode_apply_plain)(
        F, W, P, MU, lr=lr, momentum=momentum, scale=scale)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {**_ENC_LAUNCHES, **_DEC_LAUNCHES}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for table in (_ENC_LAUNCHES, _DEC_LAUNCHES):
        for k in table:
            table[k] = 0
