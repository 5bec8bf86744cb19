"""Products of the plain references, in float32 or, for the control, with
every operand rounded to TF32 first.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits.  The control
rounds each operand of a product to it (to nearest, ties to even) and then
multiplies and accumulates in float32 with TF32 off: what a tensor core in
TF32 does with operands that were rounded to nearest, on any device,
including products the library would run without tensor cores (a
matrix-vector product).  The backward of a product rounds its operands the
same way.
"""
from __future__ import annotations

import torch

_LOW = (1 << 13) - 1


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    i = x.detach().contiguous().view(torch.int32)
    odd = (i >> 13) & 1
    i = (i + (_LOW >> 1) + odd) & ~_LOW
    return i.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (torch.matmul(rg, rb.transpose(-1, -2)) if rb.dim() > 1
                  else torch.outer(rg, rb))
        if ctx.needs_input_grad[1]:
            gb = (torch.matmul(ra.transpose(-1, -2), rg) if ra.dim() > 1
                  else torch.outer(ra, rg))
        return ga, gb


class Products:
    """``mm(a, b)``: ``torch.matmul`` in float32, or with ``tf32`` the
    control's rounded one.  Operands are matrices or batches of matrices of
    the same batch shape, or a matrix and a vector."""

    def __init__(self, tf32: bool = False):
        self.tf32 = bool(tf32)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)
