"""Coded gradient ENCODE (paper eq. 17/18): wrapper of the CUDA kernel and,
beside it, the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/coded_encode.py`` (``coded_encode``:
``_encode_kernel_2d`` / ``_encode_kernel_3d``).  The contraction

    out[v(, r)] = sum_{j<d, u<m} G[j, v, u(, r)] * C[j, u]

does about half an operation per byte, so on an H100 it is bound by bytes:
one read of ``G`` plus one write of the output,
``d*V*m*R*sizeof(in) + V*R*sizeof(out)`` over 3.35 TB/s.  The kernel
(``csrc/coded_encode.cu``) is a grid-stride stream: no more blocks than fit
on the card, the coefficients in registers when ``d*m <= 8`` and
``m <= 4``, ``G`` read once in 16-byte vectors with the evict-first hint (a
thread owns 16 bytes' worth of neighbouring ``r`` in 3D, of consecutive
``v`` in 2D), two such items in flight a thread.  A scalar path in the same
kernel takes a 2D ``V`` tail, an ``R`` that is no multiple of the vector,
and bases that are not 16-byte aligned; ``encode_path`` picks the path from
the shapes and ``data_ptr()``, and ``PATH_LAUNCHES`` counts each.  On every
path an output element is the same ``fmaf`` chain from 0 over ``(j, u)`` in
f32, rounded once to ``out_dtype``: the paths agree bit for bit.  Where
``V`` is small (the main path's 2D encodes move about 2 MB) the launch, not
the bytes, sets the time.

``coded_encode_acc`` replaces the TPU kernel ``coded_encode_acc``
(``_encode_acc_kernel_2d`` / ``_encode_acc_kernel_3d``): the pipelined step's
fold of one subset gradient straight into its slot of an f32 wire bucket,
``acc += coded_encode(G, C)`` in place (the TPU kernel's
``input_output_aliases={0: 0}``).  Bound by bytes as the encode is, plus one
f32 read and write of ``acc``.  The kernel forms the sum from 0 exactly as
``coded_encode`` does and adds it to ``acc`` with one rounding, so the fold
equals the synchronous step's ``acc + coded_encode(G, C, out_dtype=f32)``
bit for bit.

On a CUDA tensor each wrapper launches its kernel or raises; the plain
version is taken only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from . import _launch

# launches of each variant; the wrapper adds one per kernel launch
LAUNCHES = {"coded_encode_2d": 0, "coded_encode_3d": 0,
            "coded_encode_acc_2d": 0, "coded_encode_acc_3d": 0}
# the same launches by the kernel's path, "vector" or "scalar"
PATH_LAUNCHES = {k: {"vector": 0, "scalar": 0} for k in LAUNCHES}

# the kernel's register form, which the vector path needs: d*m and m at
# most these (csrc/coded_encode.cu, kRegTerms and kMaxRegM)
REG_TERMS = 8
MAX_REG_M = 4


def _check_shapes(G: torch.Tensor, C: torch.Tensor):
    if G.ndim not in (3, 4):
        raise ValueError(f"G must be (d, V, m) or (d, V, m, R), got "
                         f"{tuple(G.shape)}")
    if tuple(C.shape) != (G.shape[0], G.shape[2]):
        raise ValueError(f"C must be (d, m) = {(G.shape[0], G.shape[2])}, "
                         f"got {tuple(C.shape)}")


def encode_path(G: torch.Tensor, out: torch.Tensor) -> str:
    """The kernel path for encoding ``G`` into ``out`` (or ``acc``):
    ``"vector"`` when the coefficients fit the register form (``d*m <= 8``,
    ``m <= 4``) and every 16-byte vector is aligned: both bases, and in 3D
    ``R`` a multiple of the vector's ``P`` elements of ``G``, in 2D with
    ``d > 1`` each ``G[j]`` of ``V*m`` elements too; else ``"scalar"``.
    The launcher holds the vector path to the same rule."""
    d, V, m = G.shape[:3]
    per_vector = 16 // G.element_size()
    whole = (G.shape[3] % per_vector == 0 if G.ndim == 4
             else d == 1 or V * m % per_vector == 0)
    ok = (m <= MAX_REG_M and d * m <= REG_TERMS and whole
          and G.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    return "vector" if ok else "scalar"


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
    path = encode_path(G, out)
    _launch.call("coded_encode_launch", G.device, G.data_ptr(),
                 coef.data_ptr(), out.data_ptr(), d, V, m, R, int(rank3),
                 _launch.DTYPE_CODES[G.dtype], _launch.DTYPE_CODES[out_dtype],
                 int(path == "vector"))
    name = "coded_encode_3d" if rank3 else "coded_encode_2d"
    LAUNCHES[name] += 1
    PATH_LAUNCHES[name][path] += 1
    return out


def _check_acc(acc: torch.Tensor, G: torch.Tensor):
    want = (G.shape[1], G.shape[3]) if G.ndim == 4 else (G.shape[1],)
    if tuple(acc.shape) != want:
        raise ValueError(f"acc must be {want} for G {tuple(G.shape)}, got "
                         f"{tuple(acc.shape)}")
    if acc.dtype != torch.float32:
        raise TypeError(f"acc must be float32 (wire accumulators are f32), "
                        f"got {acc.dtype}")


def coded_encode_acc_plain(acc: torch.Tensor, G: torch.Tensor,
                           C: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``acc + coded_encode_plain(G, C, f32)``, a new
    tensor (``acc`` is left as it was)."""
    _check_shapes(G, C)
    _check_acc(acc, G)
    return acc + coded_encode_plain(G, C, out_dtype=torch.float32)


def coded_encode_acc(acc: torch.Tensor, G: torch.Tensor,
                     C: torch.Tensor) -> torch.Tensor:
    """acc: (V,) or (V, R) f32; G: (d, V, m) or (d, V, m, R); C: (d, m).

    Adds ``coded_encode(G, C)`` into ``acc`` in place and returns ``acc``.
    ``acc`` must be contiguous (a slice of a flat bucket is): it is never
    copied, since a copy would take the write away from the bucket.
    """
    _check_shapes(G, C)
    _check_acc(acc, G)
    if G.device.type == "cpu" and acc.device.type == "cpu":
        return acc.copy_(coded_encode_acc_plain(acc, G, C))
    if G.device.type != "cuda":
        raise ValueError(f"coded_encode_acc runs on cuda or cpu, not "
                         f"{G.device}")
    _launch.check_operand("G", G)
    _launch.check_f32_state("acc", acc, G)
    if G.numel() == 0:
        raise ValueError(f"empty G {tuple(G.shape)}")
    d, V, m = G.shape[:3]
    rank3 = G.ndim == 4
    R = G.shape[3] if rank3 else 1
    if d * m * 4 > 48 * 1024:
        raise ValueError(f"coefficient block d*m = {d * m} floats exceeds "
                         f"the kernel's 48 KB of shared memory")
    coef = _launch.coef_f32("C", C, G)
    path = encode_path(G, acc)
    _launch.call("coded_encode_acc_launch", G.device, G.data_ptr(),
                 coef.data_ptr(), acc.data_ptr(), d, V, m, R, int(rank3),
                 _launch.DTYPE_CODES[G.dtype], int(path == "vector"))
    name = "coded_encode_acc_3d" if rank3 else "coded_encode_acc_2d"
    LAUNCHES[name] += 1
    PATH_LAUNCHES[name][path] += 1
    return acc
