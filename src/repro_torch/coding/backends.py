"""Compute backends for the codec: the same encode/decode contractions in
interchangeable implementations.

Canonical shapes (the leaf <-> canonical reshaping lives in ``codec.py``):

  encode: G (d, V, m[, R]) x C (d, m)  ->  (V[, R])      (paper eq. 17/18)
  decode: F (n, V[, R])   x W (n, m)   ->  (V, m[, R])   (paper eq. 19-21)

Backends:
  ``ref``    — the plain PyTorch versions (f32 accumulate in the kernels'
               order); run on any device and are what the kernels are held
               against.
  ``hopper`` — the hand-written CUDA kernels in ``repro_torch.kernels``;
               need a card.

``resolve_backend`` implements the dispatch policy: ``auto`` follows the
*explicit device* the codec is built for (cuda -> hopper, cpu -> ref) and
never looks at what the machine happens to have.
"""
from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..kernels.coded_decode import coded_decode, coded_decode_plain
from ..kernels.coded_encode import coded_encode, coded_encode_plain

BACKEND_NAMES = ("auto", "ref", "hopper")

_LATER = ("belongs to the pipelined (stale-by-one) step, which is not "
          "ported yet")


@dataclasses.dataclass(frozen=True)
class CodecBackend:
    """Interface: subclasses implement the two canonical contractions."""
    name: str = "abstract"

    def encode(self, G: torch.Tensor, C: torch.Tensor, *,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
        """Encode contraction: G (d, V, m[, R]) x C (d, m) -> (V[, R])."""
        raise NotImplementedError

    def decode(self, F: torch.Tensor, W: torch.Tensor, *,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
        """Decode contraction: F (n, V[, R]) x W (n, m) -> (V, m[, R])."""
        raise NotImplementedError

    def encode_acc(self, acc, G, C):
        """Accumulating encode ``acc + encode(G, C)``."""
        raise NotImplementedError(f"encode_acc {_LATER}")

    def decode_apply(self, F, W, P, MU, *, lr, momentum, scale):
        """Fused decode + SGD-momentum apply over one packed bucket."""
        raise NotImplementedError(f"decode_apply {_LATER}")


@dataclasses.dataclass(frozen=True)
class TorchRefBackend(CodecBackend):
    """Plain PyTorch backend: runs on any device and serves as the
    numerical oracle for the CUDA kernels."""
    name: str = "ref"

    def encode(self, G, C, *, out_dtype=None):
        """Plain encode, f32 accumulation, cast to ``out_dtype``."""
        return coded_encode_plain(G, C, out_dtype=out_dtype)

    def decode(self, F, W, *, out_dtype=None):
        """Plain decode, f32 accumulation, cast to ``out_dtype``."""
        return coded_decode_plain(F, W, out_dtype=out_dtype)


@dataclasses.dataclass(frozen=True)
class HopperBackend(CodecBackend):
    """The CUDA kernels of ``repro_torch.kernels``: a CUDA tensor launches
    the kernel or raises, with no way back to the plain version."""
    name: str = "hopper"

    def encode(self, G, C, *, out_dtype=None):
        """Encode via the ``coded_encode`` CUDA kernel."""
        return coded_encode(G, C, out_dtype=out_dtype)

    def decode(self, F, W, *, out_dtype=None):
        """Decode via the ``coded_decode`` CUDA kernel."""
        return coded_decode(F, W, out_dtype=out_dtype)


def resolve_backend(backend: str | CodecBackend | None,
                    device: str | torch.device = "cuda") -> CodecBackend:
    """Dispatch policy.  ``auto``: by the explicit ``device`` — the kernels
    for a cuda device, the plain versions for the cpu.  ``hopper``: the
    kernels; raises unless ``device`` is a CUDA device that exists.
    ``ref``: the plain versions on whatever ``device`` is."""
    if isinstance(backend, CodecBackend):
        return backend
    name = backend or "auto"
    if name not in BACKEND_NAMES:
        raise ValueError(f"unknown codec backend {backend!r}; "
                         f"expected one of {BACKEND_NAMES}")
    dev = resolve_device(device)
    if name == "ref":
        return TorchRefBackend()
    if name == "hopper" and dev.type != "cuda":
        raise ValueError(f"backend 'hopper' needs a cuda device, got {dev}")
    return HopperBackend() if dev.type == "cuda" else TorchRefBackend()
