"""Coded gradient DECODE (paper eq. 19-21): wrapper of the CUDA kernel and,
beside it, the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/coded_decode.py`` (``coded_decode``:
``_decode_kernel_2d`` / ``_decode_kernel_3d``).  The contraction

    out[v, u(, r)] = sum_{i<n} F[i, v(, r)] * W[i, u]

is a skinny product (``m`` is a handful of columns), so on an H100 it is
bound by bytes: one read of the ``(n, V[, R])`` stack plus one write of the
output, ``n*V*R*sizeof(in) + V*m*R*sizeof(out)`` over 3.35 TB/s.  The kernel
(``csrc/coded_decode.cu``) reads ``F`` once for ``m <= 8``: a thread per
``v`` (2D) or ``(v, r)`` (3D) walks the ``n`` rows in order with up to 8 f32
accumulators in registers, ``W`` in shared memory, a masked ragged tail in
place of tiles that had to divide ``V``.  It serves the gather schedule
(full stack) and the a2a schedule (``V/n`` slice) alike; bf16 ``F`` with
f32 output is the wire case.

``coded_decode_apply`` replaces the TPU kernel ``coded_decode_apply``
(``_decode_apply_kernel``): for one packed wire bucket of the pipelined step
it decodes, scales, and applies SGD-momentum to the ``(L, m)`` f32 bucket
views of the parameters and the momentum in the same pass, and sums ``g²``
for the step's gradient norm.  Bound by bytes: one read of ``F`` and one
read and write of ``P`` and ``MU``.  The contraction is the decode's own and
the update rounds after every multiply and add, as PyTorch's unfused ops do,
so ``p'`` and ``mu'`` equal ``coded_decode`` followed by the optimizer's
expressions bit for bit.  ``Σg²`` is summed per block and then over the
blocks in a fixed order (no float atomics): the same from run to run.

On a CUDA tensor each wrapper launches its kernel or raises; the plain
version is taken only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from . import _launch

# launches of each variant; the wrapper adds one per kernel launch
LAUNCHES = {"coded_decode_2d": 0, "coded_decode_3d": 0,
            "coded_decode_apply": 0}

THREADS = 256    # CG_THREADS of csrc/common.cuh: one Σg² partial per block


def _check_shapes(F: torch.Tensor, W: torch.Tensor):
    if F.ndim not in (2, 3):
        raise ValueError(f"F must be (n, V) or (n, V, R), got "
                         f"{tuple(F.shape)}")
    if W.ndim != 2 or W.shape[0] != F.shape[0]:
        raise ValueError(f"W must be (n, m) with n = {F.shape[0]}, got "
                         f"{tuple(W.shape)}")


def coded_decode_plain(F: torch.Tensor, W: torch.Tensor, *,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version: f32-upcast inputs, the ``n`` rank-one terms
    added in the kernel's row order, cast to ``out_dtype`` (default ``F``'s
    dtype).

    Written as elementwise products and sums, not as one ``einsum``: an
    element's rounding then depends on ``n`` only, never on ``V`` or ``R``
    (a BLAS call picks its blocking by shape), which is what the bitwise
    packed == per-leaf contract rests on where this version runs.
    """
    _check_shapes(F, W)
    F32, W32 = F.to(torch.float32), W.to(torch.float32)
    f = F32.unsqueeze(2)                                   # (n, V, 1[, R])
    w = W32[:, None, :, None] if F.ndim == 3 else W32[:, None, :]
    acc = f[0] * w[0]
    for i in range(1, F.shape[0]):
        acc = acc + f[i] * w[i]
    return acc.to(out_dtype or F.dtype)


def coded_decode(F: torch.Tensor, W: torch.Tensor, *,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """F: (n, V) or (n, V, R); W: (n, m) -> (V, m) or (V, m, R).

    Accumulation is f32; the result is written in ``out_dtype`` (default
    ``F``'s dtype; the train step asks for f32 so a bf16 wire decodes once
    into the f32 gradient).  ``F`` must be contiguous.
    """
    _check_shapes(F, W)
    out_dtype = out_dtype or F.dtype
    if F.device.type == "cpu":
        return coded_decode_plain(F, W, out_dtype=out_dtype)
    if F.device.type != "cuda":
        raise ValueError(f"coded_decode runs on cuda or cpu, not {F.device}")
    _launch.check_operand("F", F)
    if out_dtype not in _launch.DTYPE_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    if F.numel() == 0:
        raise ValueError(f"empty F {tuple(F.shape)}")
    n, V = F.shape[:2]
    m = W.shape[1]
    rank3 = F.ndim == 3
    R = F.shape[2] if rank3 else 1
    if n * m * 4 > 48 * 1024:
        raise ValueError(f"weight block n*m = {n * m} floats exceeds the "
                         f"kernel's 48 KB of shared memory")
    wts = _launch.coef_f32("W", W, F)
    out = torch.empty((V, m, R) if rank3 else (V, m), dtype=out_dtype,
                      device=F.device)
    _launch.launch("coded_decode_launch", F, wts, out, n, V, m, R, rank3)
    LAUNCHES["coded_decode_3d" if rank3 else "coded_decode_2d"] += 1
    return out


def _check_apply(F: torch.Tensor, W: torch.Tensor, P: torch.Tensor,
                 MU: torch.Tensor):
    if F.ndim != 2:
        raise ValueError(f"F must be (n, L), got {tuple(F.shape)}")
    _check_shapes(F, W)
    want = (F.shape[1], W.shape[1])
    for name, x in (("P", P), ("MU", MU)):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must be (L, m) = {want}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")


def coded_decode_apply_plain(F: torch.Tensor, W: torch.Tensor,
                             P: torch.Tensor, MU: torch.Tensor, *,
                             lr: float, momentum: float, scale: float):
    """Plain PyTorch version: ``coded_decode_plain`` to f32, the step's grad
    scaling, then the very expressions of ``optim.sgd_momentum``; returns
    new tensors ``(p', mu', Σg²)`` and leaves ``P`` and ``MU`` as they were."""
    _check_apply(F, W, P, MU)
    g = coded_decode_plain(F, W, out_dtype=torch.float32) * scale
    mu = momentum * MU + g
    return P - lr * mu, mu, torch.sum(g * g)


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def coded_decode_apply(F: torch.Tensor, W: torch.Tensor, P: torch.Tensor,
                       MU: torch.Tensor, *, lr: float, momentum: float,
                       scale: float):
    """F: (n, L) f32 or bf16; W: (n, m); P, MU: (L, m) f32.

    Overwrites ``P`` with ``p' = P - lr * mu'`` and ``MU`` with
    ``mu' = momentum * MU + g``, ``g = scale * (Fᵀ W)``, and returns
    ``(P, MU, Σg²)`` with ``Σg²`` a 0-d f32 tensor.  ``P`` and ``MU`` must be
    contiguous buffers of their own (``pack_param_groups`` makes them so):
    neither may share storage with ``F`` or with the other.
    """
    _check_apply(F, W, P, MU)
    if F.device.type == "cpu" and P.device.type == "cpu":
        pn, mun, ss = coded_decode_apply_plain(F, W, P, MU, lr=lr,
                                               momentum=momentum, scale=scale)
        P.copy_(pn)
        MU.copy_(mun)
        return P, MU, ss
    if F.device.type != "cuda":
        raise ValueError(f"coded_decode_apply runs on cuda or cpu, not "
                         f"{F.device}")
    _launch.check_operand("F", F)
    _launch.check_f32_state("P", P, F)
    _launch.check_f32_state("MU", MU, F)
    assert not (_shares_storage(P, F) or _shares_storage(MU, F)
                or _shares_storage(P, MU)), \
        "P and MU are written in place: they may not share storage with F " \
        "or with each other"
    if F.numel() == 0:
        raise ValueError(f"empty F {tuple(F.shape)}")
    n, L = F.shape
    m = W.shape[1]
    if (n * m + THREADS) * 4 > 48 * 1024:
        raise ValueError(f"weight block n*m = {n * m} floats exceeds the "
                         f"kernel's 48 KB of shared memory")
    wts = _launch.coef_f32("W", W, F)
    blocks = -(-L // THREADS)
    partials = torch.empty((blocks,), dtype=torch.float32, device=F.device)
    ss = torch.empty((), dtype=torch.float32, device=F.device)
    _launch.call("coded_decode_apply_launch", F.device, F.data_ptr(),
                 wts.data_ptr(), P.data_ptr(), MU.data_ptr(),
                 partials.data_ptr(), ss.data_ptr(), n, L, m, float(lr),
                 float(momentum), float(scale), _launch.DTYPE_CODES[F.dtype],
                 blocks)
    LAUNCHES["coded_decode_apply"] += 1
    return P, MU, ss
