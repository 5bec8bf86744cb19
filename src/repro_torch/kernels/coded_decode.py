"""Coded gradient DECODE (paper eq. 19-21): wrapper of the CUDA kernel and,
beside it, the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/coded_decode.py`` (``coded_decode``:
``_decode_kernel_2d`` / ``_decode_kernel_3d``).  The contraction

    out[v, u(, r)] = sum_{i<n} F[i, v(, r)] * W[i, u]

is a skinny product (``m`` is a handful of columns), so on an H100 it is
bound by bytes: one read of the ``(n, V[, R])`` stack plus one write of the
output, ``n*V*R*sizeof(in) + V*m*R*sizeof(out)`` over 3.35 TB/s.  In the
2D kernel (``csrc/coded_decode.cu``) a thread owns 4 consecutive ``v``: it
reads ``F`` in 16-byte (f32) or 8-byte (bf16) vectors, every row of its item
in flight before its first multiply-add, and writes its ``4*m`` consecutive
outputs as 16-byte stores; one block per 256 items (128 or 64 where that
would leave SMs idle), ``W`` in registers when ``n*m <= 16``
(``REG_TERMS``; the training and serving codes) and in shared memory above
that, ``F`` read evict-first when the L2 could hold it.  The vector path
takes ``m`` in ``VEC_M``; a scalar path in the same kernel takes a ``V``
tail, bases that are not 16-byte aligned and rows ``F[i]`` that are not;
``decode_path`` picks the path from the shapes and ``data_ptr()``, and
``PATH_LAUNCHES`` counts each.  Other ``m`` run a general scalar form.  The
3D kernel keeps a thread per ``(v, r)``, ``W`` in shared memory.  On every
path an output element is the same ``fmaf`` chain from 0 over the rows in
order, in f32, rounded once to ``out_dtype``: the paths agree bit for bit.
It serves the gather schedule (full stack) and the a2a schedule (``V/n``
slice) alike; bf16 ``F`` with f32 output is the wire case.

``coded_decode_apply`` replaces the TPU kernel ``coded_decode_apply``
(``_decode_apply_kernel``): for one packed wire bucket of the pipelined step
it decodes, scales, and applies SGD-momentum to the ``(L, m)`` f32 bucket
views of the parameters and the momentum in the same pass, and sums ``g²``
for the step's gradient norm.  Bound by bytes: one read of ``F`` and one
read and write of ``P`` and ``MU``, which the vector path moves as 16-byte
vectors beside ``F``'s.  The contraction is the decode's own and the update
rounds after every multiply and add, as PyTorch's unfused ops do, so ``p'``
and ``mu'`` equal ``coded_decode`` followed by the optimizer's expressions
bit for bit.  It is one launch: each block writes its ``Σg²`` partial (a
fixed tree over its threads) and the last block to finish, found by an
integer atomic on a counter of the calling stream's own, adds the partials
in index order and resets the counter (no float atomics: the same from call
to call on one card).

On a CUDA tensor each wrapper launches its kernel or raises; the plain
version is taken only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from . import _launch

# launches of each variant; the wrapper adds one per kernel launch
LAUNCHES = {"coded_decode_2d": 0, "coded_decode_3d": 0,
            "coded_decode_apply": 0}
# the launches of the 2D kernel by its path, "vector" or "scalar"
PATH_LAUNCHES = {k: {"vector": 0, "scalar": 0}
                 for k in ("coded_decode_2d", "coded_decode_apply")}

THREADS = 256    # CG_THREADS of csrc/common.cuh: threads a block
# the 2D kernel's vector path takes these m (csrc/coded_decode.cu,
# vector_m); any other m runs the general scalar form
VEC_M = (1, 2, 3, 4, 8)
# n*m up to this: W in registers, above it in shared memory
# (csrc/coded_decode.cu, kRegTerms); either form has both paths
REG_TERMS = 16


def _check_shapes(F: torch.Tensor, W: torch.Tensor):
    if F.ndim not in (2, 3):
        raise ValueError(f"F must be (n, V) or (n, V, R), got "
                         f"{tuple(F.shape)}")
    if W.ndim != 2 or W.shape[0] != F.shape[0]:
        raise ValueError(f"W must be (n, m) with n = {F.shape[0]}, got "
                         f"{tuple(W.shape)}")


def decode_path(F: torch.Tensor, out: torch.Tensor) -> str:
    """The 2D kernel's path for decoding ``F (n, V)`` into ``out (V, m)``
    (or for the fused update of ``P`` or ``MU``): ``"vector"`` when ``m`` is
    one of ``VEC_M`` and both bases are 16-byte aligned, and so is each row
    ``F[i]`` when ``n > 1`` (``V*sizeof(in)`` a multiple of 16; one rule for
    both input types, though bf16 is read in 8-byte vectors); else
    ``"scalar"``.  A ``V`` that is no multiple of the vector stays on
    the vector path (the kernel's scalar loop takes the tail).  The
    launcher holds the vector path to the same rule."""
    if F.ndim != 2:
        raise ValueError(f"decode_path takes a 2D F, got {tuple(F.shape)}")
    n, V = F.shape
    ok = (out.shape[-1] in VEC_M
          and (n == 1 or V * F.element_size() % 16 == 0)
          and F.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    return "vector" if ok else "scalar"


def apply_path(F: torch.Tensor, P: torch.Tensor, MU: torch.Tensor) -> str:
    """The fused decode-apply's path: ``"vector"`` when ``decode_path``
    gives it for both ``P`` and ``MU``, else ``"scalar"``."""
    return ("vector" if decode_path(F, P) == decode_path(F, MU) == "vector"
            else "scalar")


def partial_slots(L: int) -> int:
    """Slots of the ``Σg²`` partials scratch for a bucket of ``L`` rows: one
    per ``THREADS`` rows.  Bounds the kernel's grid on either path, which is
    at most one block per ``THREADS`` of its items (``L`` on the scalar
    path, fewer on the vector path); the launcher refuses a larger grid."""
    return -(-L // THREADS)


# one counter of finished blocks per (device, stream): the kernel leaves it
# 0, so one stream's launches can share it; two streams need two
_DONE_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _done_counter(device: torch.device) -> torch.Tensor:
    """The current stream's counter of finished blocks on ``device``, made
    (zeroed, on that stream) at its first use."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    if key not in _DONE_COUNTERS:
        with torch.cuda.device(device):
            _DONE_COUNTERS[key] = torch.zeros(1, dtype=torch.int32,
                                              device=device)
    return _DONE_COUNTERS[key]


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
    path = "scalar" if rank3 else decode_path(F, out)
    _launch.call("coded_decode_launch", F.device, F.data_ptr(),
                 wts.data_ptr(), out.data_ptr(), n, V, m, R, int(rank3),
                 _launch.DTYPE_CODES[F.dtype], _launch.DTYPE_CODES[out_dtype],
                 int(path == "vector"))
    if rank3:
        LAUNCHES["coded_decode_3d"] += 1
    else:
        LAUNCHES["coded_decode_2d"] += 1
        PATH_LAUNCHES["coded_decode_2d"][path] += 1
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
    slots = partial_slots(L)
    partials = torch.empty((slots,), dtype=torch.float32, device=F.device)
    ss = torch.empty((), dtype=torch.float32, device=F.device)
    path = apply_path(F, P, MU)
    _launch.call("coded_decode_apply_launch", F.device, F.data_ptr(),
                 wts.data_ptr(), P.data_ptr(), MU.data_ptr(),
                 partials.data_ptr(), _done_counter(F.device).data_ptr(),
                 ss.data_ptr(), n, L, m, float(lr), float(momentum),
                 float(scale), _launch.DTYPE_CODES[F.dtype], slots,
                 int(path == "vector"))
    LAUNCHES["coded_decode_apply"] += 1
    PATH_LAUNCHES["coded_decode_apply"][path] += 1
    return P, MU, ss
