"""What the kernel wrappers share: argument checks, type codes and the call
through ``ctypes``."""
from __future__ import annotations

import torch

from . import _build

# element type codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operand(name: str, x: torch.Tensor, like: torch.Tensor | None = None):
    """Raise on what the kernels do not take: a type other than f32 or
    bf16, a strided view, or an operand on another device than ``like``."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}; the kernels "
                        f"take float32 and bfloat16")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous, got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    if like is not None and x.device != like.device:
        raise ValueError(f"{name}: on {x.device}, expected {like.device}")


def check_f32_state(name: str, x: torch.Tensor, like: torch.Tensor):
    """Raise unless ``x`` is an f32 operand the kernel may write in place:
    contiguous, on ``like``'s device.  Never copies (a copy would take the
    write away from the caller's buffer)."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: must be float32 (updated in place), got "
                        f"{x.dtype}")
    check_operand(name, x, like)


def coef_f32(name: str, c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The small coefficient block as contiguous f32 on ``like``'s device
    (an exact upcast; the kernels read coefficients as f32)."""
    if c.device != like.device:
        raise ValueError(f"{name}: on {c.device}, expected {like.device}")
    return c.to(torch.float32).contiguous()


def call(fn_name: str, device: torch.device, *args):
    """Call ``fn_name`` of the built library with ``args`` and PyTorch's
    current stream of ``device`` as the last argument; raise when the launch
    is refused.  Does not synchronise."""
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{fn_name} failed with code {rc} (negative: refused by the "
            f"launcher, positive: cudaError_t) for arguments {args}")

