"""Wire-dtype handling for the coded collectives: names, and the cast.

The reference bitcasts sub-f32 payloads to u16 around each collective to
stop its compiler from hoisting the upcast above it; PyTorch runs eagerly
and moves what it is given, so here the wire is just a cast.
"""
from __future__ import annotations

import torch

# the types the encode / decode kernels take
WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def wire_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """Resolve a wire dtype name ("float32" | "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        if dtype not in WIRE_DTYPES.values():
            raise ValueError(f"unsupported wire dtype {dtype}")
        return dtype
    try:
        return WIRE_DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unknown wire dtype {dtype!r}; expected one of "
                         f"{tuple(WIRE_DTYPES)}") from None


def dtype_name(dtype: str | torch.dtype) -> str:
    """The canonical name of a wire dtype ("float32", ...)."""
    dt = wire_dtype(dtype)
    return next(k for k, v in WIRE_DTYPES.items() if v == dt)


def to_wire(e: torch.Tensor, mask_i: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Mask the straggler payload (a straggler transmits nothing: its
    encoding is multiplied by 0) and cast to the wire dtype."""
    return (e * mask_i).to(dtype)
