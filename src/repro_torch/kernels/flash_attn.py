"""Flash attention, forward and backward: wrappers of the CUDA kernels and,
beside them, the plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attn.py`` (``flash_attention``,
``_flash_kernel``, and its layout wrapper ``flash_attention_gqa``): attention
with an online softmax, a running ``(m, l, acc)`` state in f32, scale
``1/sqrt(hd)``, ``-1e30`` for masked scores, the denominator floored at
``1e-30``, masks ``causal`` / ``full`` / ``window`` taken from absolute
positions (query row ``i`` at ``kv_pos0 + i``, key ``j`` at ``j``) with no mask
tensor, and the output in the input type.

Causal attention does ``2 S^2 H hd`` operations on ``2 S (H + Hkv) hd``
elements, several hundred operations a byte at the prompts that reach it, so
on an H100 it is bound by the tensor cores.  The kernel
(``csrc/flash_attn.cu``) runs both products on them with ``wgmma``: f32
inputs as 3xTF32 (each operand split into two TF32 parts, three products
summed in f32, about 1e-6 relative), bf16 inputs in one bf16 pass with f32
sums.  K and V tiles arrive by TMA in a ring of shared-memory stages that a
producer warp keeps ahead of the math; key tiles the mask empties are never
loaded (half of the causal work), and the shared KV head ``h // q_per_kv`` is
read in place instead of repeating K and V ``q_per_kv`` times in memory as
the TPU wrapper does.  It takes the model layout ``(B, S, H, hd)`` through
strides (TMA needs 16-byte aligned bases and strides), f32 or bf16, ``hd``
in 32, 64 or 128.

The gradient (``csrc/flash_attn_bwd.cu``; the TPU kernel has none, the
reference differentiates ``online_attention`` with XLA's autodiff) is a
``torch.autograd.Function``: under grad mode, with an input that requires
grad, the forward kernel also writes each row's log-sum-exp, and the
backward launches three kernels (``D = rowsum(dO o O)``; dK and dV per key
tile, summed over the query heads of a KV head inside the block; dQ per
query tile), which recompute the probabilities from that residual and use
no atomics, so the gradient's bits repeat from call to call.  Their
products run on the tensor cores as the forward's do (3xTF32 ``wgmma`` for
f32, one bf16 pass), fed by TMA, so ``dout`` too must be contiguous with a
16-byte aligned base.  Outside grad mode the forward runs alone and writes
no residual.

The plain version is the reference's oracle, ``models/common.py``'s
``online_attention``: the same ordered loop over query chunks and key chunks
(the reference's default chunks, 256 and 1024), in the reference's types.
It stays differentiable: on the CPU autograd differentiates the loop.

On a CUDA tensor the wrapper launches the kernel or raises; the plain version
is taken only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _launch

MASK_KINDS = {"causal": 0, "full": 1, "window": 2}   # codes of csrc/flash_attn.cu
HEAD_DIMS = (32, 64, 128)                            # what the kernel is built for
CHUNK_Q = 256            # the reference's online_attention chunks
CHUNK_KV = 1024
TMA_ALIGN = 16           # bytes: TMA's alignment of bases and strides

# launches of the kernels; the wrappers add one per launch (the backward's
# three kernels are one launch of its entry point)
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
# calls of the plain version, wherever they come from (a run on the card
# reads it to show that its main path never took the plain version)
PLAIN_CALLS = {"flash_attention": 0}


def _check(q, k, v, q_per_kv: int, mask_kind: str, kv_pos0: int):
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd) "
                         f"alike; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[2] * q_per_kv != H:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         f"with q_per_kv={q_per_kv}")
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"unknown mask_kind {mask_kind!r}; expected one of "
                         f"{tuple(MASK_KINDS)}")
    if kv_pos0 < 0:
        raise ValueError(f"kv_pos0 must be >= 0, got {kv_pos0}")


def tma_refusal(name: str, x: torch.Tensor) -> str | None:
    """Why TMA cannot read ``x`` (B, S, heads, hd) in place, or None: its
    base, and the stride of every dimension longer than 1, must be
    multiples of 16 bytes.  The kernel never copies to get round it."""
    esz = x.element_size()
    if x.data_ptr() % TMA_ALIGN:
        return (f"{name}: data_ptr {x.data_ptr():#x} is not a multiple of "
                f"{TMA_ALIGN} bytes")
    for d in range(3):
        st = x.stride(d) * esz
        if x.shape[d] > 1 and (st <= 0 or st % TMA_ALIGN):
            return (f"{name}: stride {x.stride(d)} of dim {d} is {st} bytes, "
                    f"not a positive multiple of {TMA_ALIGN}")
    return None


def _chunk(size: int, chunk: int) -> int:
    """The reference's chunk: the largest divisor of ``size`` up to ``chunk``."""
    c = min(chunk, size)
    while size % c:
        c -= 1
    return c


def flash_attention_gqa_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_per_kv: int, *,
                              mask_kind: str = "causal", window: int = 0,
                              kv_pos0: int = 0, chunk_q: int = CHUNK_Q,
                              chunk_kv: int = CHUNK_KV) -> torch.Tensor:
    """Plain PyTorch version: the reference's ``online_attention``.

    q (B, Sq, H, hd), k / v (B, Sk, Hkv, hd) -> (B, Sq, H, hd) in q's type.
    Query chunks in order; within one, key chunks in order with the running
    ``(m, l, o)`` state in f32; scores and ``p @ v`` are products in the
    input type, as in the reference.  Never materialises ``(Sq, Sk)``.
    """
    _check(q, k, v, q_per_kv, mask_kind, kv_pos0)
    PLAIN_CALLS["flash_attention"] += 1
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    cq, ckv = _chunk(Sq, chunk_q), _chunk(Sk, chunk_kv)
    nq, nk = Sq // cq, Sk // ckv
    scale = 1.0 / np.sqrt(hd)
    f32, dev = torch.float32, q.device
    qr = q.reshape(B, nq, cq, Hkv, q_per_kv, hd)
    kr = k.reshape(B, nk, ckv, Hkv, hd)
    vr = v.reshape(B, nk, ckv, Hkv, hd)
    blocks = []
    for qi in range(nq):
        qc = qr[:, qi]                                   # (B, cq, Hkv, g, hd)
        qpos = kv_pos0 + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((B, Hkv, q_per_kv, cq), -1e30, dtype=f32, device=dev)
        l = torch.zeros((B, Hkv, q_per_kv, cq), dtype=f32, device=dev)
        o = torch.zeros((B, Hkv, q_per_kv, cq, hd), dtype=f32, device=dev)
        for kj in range(nk):
            kc, vc = kr[:, kj], vr[:, kj]
            kpos = kj * ckv + torch.arange(ckv, device=dev)
            s = torch.einsum("bqhgk,bshk->bhgqs", qc, kc).to(f32) * scale
            if mask_kind == "causal":
                valid = kpos[None, :] <= qpos[:, None]
            elif mask_kind == "window":
                valid = ((kpos[None, :] <= qpos[:, None])
                         & (kpos[None, :] > qpos[:, None] - window))
            else:
                valid = torch.ones((cq, ckv), dtype=torch.bool, device=dev)
            s = torch.where(valid, s, torch.tensor(-1e30, dtype=f32, device=dev))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "bhgqs,bshk->bhgqk", p.to(qc.dtype), vc).to(f32)
            m = m_new
        o = o / torch.clamp_min(l, 1e-30)[..., None]
        blocks.append(o.permute(0, 3, 1, 2, 4))          # (B, cq, Hkv, g, hd)
    out = torch.stack(blocks, dim=1)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_per_kv: int, *, mask_kind: str = "causal",
                        window: int = 0, kv_pos0: int = 0,
                        chunk_q: int = CHUNK_Q,
                        chunk_kv: int = CHUNK_KV) -> torch.Tensor:
    """q (B, Sq, H, hd), k / v (B, Sk, Hkv, hd) -> (B, Sq, H, hd) in q's type.

    Query head ``h`` attends with KV head ``h // q_per_kv``.  On the card the
    kernel runs with tiles of its own (``chunk_q`` / ``chunk_kv`` shape only
    the plain version) and raises on what it does not take: a type other
    than f32 or bf16, mixed types, ``hd`` outside 32, 64 and 128, a last
    dimension that is not contiguous, a base or a stride that is not a
    multiple of 16 bytes, or a query row with no key in its window (the
    reference would average all of V there).  Under grad mode, when q, k or
    v requires grad, the call is differentiable through the backward
    kernel.
    """
    _check(q, k, v, q_per_kv, mask_kind, kv_pos0)
    if q.device.type == "cpu":
        return flash_attention_gqa_plain(
            q, k, v, q_per_kv, mask_kind=mask_kind, window=window,
            kv_pos0=kv_pos0, chunk_q=chunk_q, chunk_kv=chunk_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_cuda(q, k, v, mask_kind, window, kv_pos0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        # the kernels read q_per_kv from the shapes (H // Hkv)
        return _FlashAttention.apply(q, k, v, mask_kind, window, kv_pos0)
    return _forward(q, k, v, mask_kind, window, kv_pos0, residual=False)[0]


def _check_cuda(q, k, v, mask_kind: str, window: int, kv_pos0: int):
    """Raise on what the kernels do not take (see ``flash_attention_gqa``)."""
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name}: on {x.device}, expected {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name}: {x.dtype}, expected q's {q.dtype}")
    if q.dtype not in _launch.DTYPE_CODES:
        raise TypeError(f"q: unsupported dtype {q.dtype}; the kernel takes "
                        f"float32 and bfloat16")
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q, k, v need unit stride along head_dim")
    for name, x in (("q", q), ("k", k), ("v", v)):
        why = tma_refusal(name, x)
        if why:
            raise ValueError(why)
    if 0 in (B, Sq, Sk, H):
        raise ValueError(f"empty attention q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if mask_kind == "window" and (window < 1 or kv_pos0 + Sq - window > Sk - 1):
        raise ValueError(f"window={window} with kv_pos0={kv_pos0}, Sq={Sq}, "
                         f"Sk={Sk} leaves a query row with no key")


def _forward(q, k, v, mask_kind: str, window: int, kv_pos0: int, *,
             residual: bool):
    """Launch the forward kernel on checked operands: (out, lse), where
    ``lse`` is the (B, H, Sq) f32 log-sum-exp of each row in log2 units
    when ``residual`` is set, else None (the kernel writes none)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if residual else None)
    _launch.call("flash_attention_launch", q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if residual else None, B, Sq, Sk, H, Hkv,
                 hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 MASK_KINDS[mask_kind], int(window), int(kv_pos0),
                 1.0 / math.sqrt(hd), _launch.DTYPE_CODES[q.dtype])
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, mask_kind: str = "causal",
                        window: int = 0, kv_pos0: int = 0):
    """The backward kernels: (dq, dk, dv) of ``flash_attention_gqa`` at
    (q, k, v), given its output ``out``, the forward's residual ``lse``
    ((B, H, Sq) f32, log2 units) and the output's gradient ``dout``.  dq is
    (B, Sq, H, hd) and dk, dv (B, Sk, Hkv, hd), contiguous, in q's type.
    CUDA tensors only; ``dout`` is copied when it is not contiguous with a
    16-byte aligned base."""
    _check_cuda(q, k, v, mask_kind, window, kv_pos0)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dout = dout.to(q.dtype).contiguous()
    if dout.data_ptr() % TMA_ALIGN:
        dout = dout.clone()
    for name, x, shape, dt in (("out", out, (B, Sq, H, hd), q.dtype),
                               ("lse", lse, (B, H, Sq), torch.float32),
                               ("dout", dout, (B, Sq, H, hd), q.dtype)):
        if (tuple(x.shape) != shape or x.dtype != dt or x.device != q.device
                or not x.is_contiguous() or x.data_ptr() % TMA_ALIGN):
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned "
                             f"{shape} {dt} on {q.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, Hkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch.call("flash_attention_bwd_launch", q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 dsum.data_ptr(), B, Sq, Sk, H, Hkv, hd, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], MASK_KINDS[mask_kind],
                 int(window), int(kv_pos0), 1.0 / math.sqrt(hd),
                 _launch.DTYPE_CODES[q.dtype])
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its residual, differentiated by the backward
    kernels (once: the backward itself is not differentiable)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_kind, window, kv_pos0):
        out, lse = _forward(q, k, v, mask_kind, window, kv_pos0,
                            residual=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (mask_kind, window, kv_pos0)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mask_kind, window, kv_pos0 = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         mask_kind=mask_kind, window=window,
                                         kv_pos0=kv_pos0)
        return dq, dk, dv, None, None, None
