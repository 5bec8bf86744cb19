"""Coded gradient ENCODE (paper eq. 17/18): wrapper of the CUDA kernel and,
beside it, the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/coded_encode.py`` (``coded_encode``:
``_encode_kernel_2d`` / ``_encode_kernel_3d``).  The contraction

    out[v(, r)] = sum_{j<d, u<m} G[j, v, u(, r)] * C[j, u]

does about one operation per byte, so on an H100 it is bound by bytes: one
read of ``G`` plus one write of the output,
``d*V*m*R*sizeof(in) + V*R*sizeof(out)`` over 3.35 TB/s.  The kernel
(``csrc/coded_encode.cu``) reads ``G`` exactly once: a thread per output
element, ``C`` in shared memory, f32 accumulation in ``(j, u)`` order, one
store in ``out_dtype``, a masked ragged tail in place of the TPU version's
tiles that had to divide ``V``.

On a CUDA tensor ``coded_encode`` launches the kernel or raises; the plain
version is taken only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from . import _launch

# launches of each rank variant; the wrapper adds one per kernel launch
LAUNCHES = {"coded_encode_2d": 0, "coded_encode_3d": 0}


def _check_shapes(G: torch.Tensor, C: torch.Tensor):
    if G.ndim not in (3, 4):
        raise ValueError(f"G must be (d, V, m) or (d, V, m, R), got "
                         f"{tuple(G.shape)}")
    if tuple(C.shape) != (G.shape[0], G.shape[2]):
        raise ValueError(f"C must be (d, m) = {(G.shape[0], G.shape[2])}, "
                         f"got {tuple(C.shape)}")


def coded_encode_plain(G: torch.Tensor, C: torch.Tensor, *,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version: f32-upcast inputs, the ``d*m`` terms added in
    the kernel's ``(j, u)`` order, cast to ``out_dtype`` (default ``G``'s
    dtype).

    Written as elementwise products and sums, not as one ``einsum``: an
    element's rounding then depends on ``d`` and ``m`` only, never on ``V``
    or ``R`` (a BLAS call picks its blocking by shape), which is what the
    bitwise packed == per-leaf contract rests on where this version runs.
    """
    _check_shapes(G, C)
    G32, C32 = G.to(torch.float32), C.to(torch.float32)
    d, _, m = G.shape[:3]
    acc = None
    for j in range(d):
        for u in range(m):
            term = G32[j, :, u] * C32[j, u]
            acc = term if acc is None else acc + term
    return acc.to(out_dtype or G.dtype)


def coded_encode(G: torch.Tensor, C: torch.Tensor, *,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """G: (d, V, m) or (d, V, m, R); C: (d, m) -> (V,) or (V, R).

    Accumulation is f32; the result is written in ``out_dtype`` (default
    ``G``'s dtype).  ``G`` must be contiguous.
    """
    _check_shapes(G, C)
    out_dtype = out_dtype or G.dtype
    if G.device.type == "cpu":
        return coded_encode_plain(G, C, out_dtype=out_dtype)
    if G.device.type != "cuda":
        raise ValueError(f"coded_encode runs on cuda or cpu, not {G.device}")
    _launch.check_operand("G", G)
    if out_dtype not in _launch.DTYPE_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    if G.numel() == 0:
        raise ValueError(f"empty G {tuple(G.shape)}")
    d, V, m = G.shape[:3]
    rank3 = G.ndim == 4
    R = G.shape[3] if rank3 else 1
    if d * m * 4 > 48 * 1024:
        raise ValueError(f"coefficient block d*m = {d * m} floats exceeds "
                         f"the kernel's 48 KB of shared memory")
    coef = _launch.coef_f32("C", C, G)
    out = torch.empty((V, R) if rank3 else (V,), dtype=out_dtype,
                      device=G.device)
    _launch.launch("coded_encode_launch", G, coef, out, d, V, m, R, rank3)
    LAUNCHES["coded_encode_3d" if rank3 else "coded_encode_2d"] += 1
    return out
