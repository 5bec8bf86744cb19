#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--global-batch 512] [--profile] [--out report.json]

Drives ``repro_torch`` only (nothing of the JAX package), on the card only:

  env      versions, and the card's name and power limit from nvidia-smi
  build    compiles ``src/repro_torch/kernels/csrc/*.cu`` with nvcc into
           ``build/`` and loads the library
  kernels  holds each CUDA kernel (coded_encode / coded_decode, 2D and 3D;
           coded_encode_acc 2D and 3D; coded_decode_apply) against its plain
           PyTorch version over ragged sweeps and every path's own shapes
           (the serving path's encode and decode included) in f32 and bf16,
           the plain pair also against ``torch.einsum``, the fused pair bitwise
           against their two-step spellings on the card, the scalar path of
           the encodes, the 2D decode and the fused decode-apply (operands
           one element off an aligned base) bitwise against their vector
           path, the fused decode-apply as one device kernel a call (read by
           torch.profiler); and times each at the main path's shapes, on
           inputs that are not in the L2 cache, beside its plain version,
           one library call where there is one, and its byte bound; the
           coding kernels also as a run of 64 back-to-back launches and by
           the host's cost a call (200 calls, no sync), beside the launch
           floor (an empty kernel of the library, timed both ways)
  checks_packed_small
           ROADMAP C.3 on the card: packed == per-leaf bitwise on the kernel
           backend for the trees [(8,)] and [(8,), (16,)], code (4, 3, 1, 2),
           both schedules and both wire types
  train    the synchronous path: ``Trainer`` on ``logistic-paper`` at full
           width (l = 343474), code (n, d, s, m) = (8, 4, 2, 2), NAG, random
           stragglers, 5 steps
  train_pipelined
           the pipelined path: the same ``Trainer`` with
           ``SchemeSpec(pipelined=True, fuse_apply=True)`` and SGD-momentum,
           5 steps and a drain (``coded_encode_acc`` 2D and
           ``coded_decode_apply``)
  train_generic
           a two-layer MLP as a plain parameter dict through
           ``make_coded_train_step`` (trailing dims -> the 3D kernel
           variants), synchronous and pipelined fused.  Each of the three
           paths has its own counts: the kernel launch counts are set to 0
           just before it and read just after it; each of its encodes,
           2D decodes and fused decode-applies must have taken the vector
           path.
  checks   the synchronous 5 steps on the plain backend on the card, the
           decoded gradient with 2 stragglers against the uncoded gradient,
           packed against per-leaf bitwise; pipelined fill + drain against
           the synchronous step bitwise (fused and not), a steady call
           against the synchronous update of the batch it retires, and the
           pipelined run against the plain backend
  autotune_train
           ``Trainer(autotune=AutotunePolicy(...))`` on ``logistic-paper`` at
           full width from code (8, 4, 2, 2), NAG, a drifting timed straggler
           source (the reference's drift of tests/test_tune.py), exact and
           FRC plans: 16 steps counted from 0, each step's launches by kernel
           and kernel path filed under the scheme it ran under, at least one
           switch, every scheme that codes beta launching the 2D encode and
           decode; a plain-backend twin replaying the same swaps at the same
           steps (beta within rtol 1e-4); swaps back build nothing; a
           pipelined fused trainer swapped with an update in flight (the swap
           launches one ``coded_decode_apply``: the drain under the outgoing
           code), against its plain twin; one step each under a forced
           rotation, block, hetero and expander plan; the coding kernels
           timed at every coded scheme's own shapes, vector and scalar path
  serve    the serving path: ``CodedServer`` on ``qwen3-1.7b`` at full width
           (28 layers, d_model 2048, random weights from a seed, f32) with
           code (4, 3, 1, 2), one request per subset and 4096-token prompts:
           3 batches submitted and stepped, every prefill's attention through
           the flash attention kernel (n * d * 28 = 336 launches a batch);
           the decoded logits against the uncoded forward of the same
           prompts, the hedge (a straggler's payload never reaches the
           output bits), and no failed requests
  autotune_serve
           ``CodedServer(autotune=ServingPolicy(...))`` on the serve phase's
           weights, 4096-token prompts, from code (4, 3, 1, 2) under a
           drifting timed source: 10 batches counted from 0, each batch's
           flash launches (n * d * 28 of its scheme) and coding launches by
           path filed under its scheme, at least one change of code; each
           scheme's first batch against the uncoded forward, and one traced
           batch a scheme for its device idle share; the coding kernels
           timed at each scheme's shapes, vector and scalar path
  checkpoint
           (a) ``Trainer`` on ``logistic-paper`` at full width, code (8, 4,
           2, 2), NAG, random stragglers, a snapshot every 2 steps into a
           temporary directory: 6 steps, the step-6 snapshot torn to a third
           of its size, a fresh ``Trainer`` that warns ``unreadable``, falls
           back to step 4, replays the data stream (``skip_to_cursor``) and
           the straggler stream to its cursor and takes 2 steps (counted from
           0): the uninterrupted run's parameters and state, bitwise.
           (b) inside ``train_lm``, after the synchronous steps: that
           trainer's parameters and NAG state (16.3 GB) saved with
           ``maybe_checkpoint(force=True)`` and restored onto the host into a
           tree of the same structure, compared leaf by leaf bitwise; the
           directory's free bytes, the seconds and GB/s of both
  generate ``BatchedEngine`` on the serve phase's ``qwen3-1.7b`` weights at
           full width and depth, f32: 4 prompts of 4096 tokens from a seed,
           a dense cache of 4096 + 32 positions, 32 greedy tokens; counted
           from 0 just before ``generate``: the prefill launches the flash
           forward once a layer, the decode never; decode steps 0, 1 and 31
           against the full-prompt forward of prompt ++ tokens with the
           materialized f32 softmax (rtol = atol = 2e-4), the forward
           through the flash kernel printed beside; the prefill's seconds, a decode step's median ms (steps
           2-31, CUDA events), tokens/s, peak memory and the step's byte
           bound (the weights but the input embedding, and the KV cache)
  train_lm coded training of the same ``qwen3-1.7b`` at full width on
           4096-token sequences, code (4, 3, 1, 2), one sequence a subset
           (a global batch of 4), random stragglers: ``Trainer`` with NAG
           over all 28 layers, 3 steps; then the pipelined ``Trainer``
           (``fuse_apply=True``, SGD-momentum), also at full width and
           depth, 3 steps and a drain.  Each
           path counted from 0: flash forward twice a layer and subset (the
           checkpoint recomputes it), its backward once, one encode a coded
           leaf and subset, one decode (or decode-apply) a bucket; no plain
           flash call.  Outside the counts: the decoded gradient with a
           straggler against the uncoded one, and fill + drain against the
           synchronous step, bitwise

The kernel checks also hold ``flash_attention`` (tensor cores: 3xTF32 for
f32, one bf16 pass for bf16) against its plain version (the reference's
online-softmax loop) at the sweep of tests/test_kernels.py, at the serving
shape, with a window and a query offset, at hd 32 and 64 with a ragged S,
q_per_kv = 4, B > 1 with a window and an offset, and on views of one fused
projection; check what it refuses (TMA alignment) and that under grad mode it is
differentiable; and time it beside ``scaled_dot_product_attention`` in
the same type, against the tensor-core bounds.  They hold the flash
backward (``csrc/flash_attn_bwd.cu``) against the plain version's autograd
over the same sweep and the backward's tile edges (f32 1e-5 in relative
error norm and 1e-4 of the largest gradient elementwise, bf16 2e-2 in
relative norm), require the same bits from a second call, and the
forward's bits with and without its log-sum-exp residual; and time the
backward at the 4096-token shape beside SDPA's backward in the same type.
The build phase reports every flash kernel's registers and spills, forward
and backward, and the shared memory of both, and fails if one spills.
Float32 products
of the plain versions run in full f32: TF32 is switched off for matmuls
and cuDNN.

Each phase prints one JSON line.  Any failed phase ends the run with a
non-zero exit code; without a CUDA device the script exits with code 2 and
prints no result.  The last line of standard output is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

HERE = pathlib.Path(__file__).resolve().parent

# the LM training path allocates and frees buffers of several GB; segments
# that grow in place keep the cache from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
try:
    import torch
except ImportError:
    print("chip_smoke: PyTorch is not installed", file=sys.stderr)
    sys.exit(2)

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script runs "
          "on an NVIDIA GPU only", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, str(HERE / "src"))
try:
    import numpy as np

    from repro_torch import coding, convert
    from repro_torch.configs import get_config
    from repro_torch.core import make_code
    from repro_torch.data import CodedBatcher, make_synthetic_batch
    from repro_torch.kernels import _build, _launch, flash_attn, ops
    from repro_torch.kernels.coded_decode import (coded_decode,
                                                  coded_decode_apply,
                                                  coded_decode_apply_plain,
                                                  coded_decode_plain,
                                                  apply_path, decode_path)
    from repro_torch.kernels.coded_encode import (coded_encode,
                                                  coded_encode_acc,
                                                  coded_encode_acc_plain,
                                                  coded_encode_plain,
                                                  encode_path)
    from repro_torch.models import api as model_api
    from repro_torch.models import common as model_common
    from repro_torch.optim import nag, sgd_momentum
    from repro_torch.serving import BatchedEngine, CodedServer
    from repro_torch.train import (PipelineDriver, Trainer,
                                   make_coded_train_step)
    from repro_torch.tune import RandomStragglers
except ImportError as e:
    print(f"chip_smoke: the port's package does not import from "
          f"{HERE / 'src'}: {e}", file=sys.stderr)
    sys.exit(3)

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor-core rate, dense
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 tensor-core rate, dense
L2_BYTES = 50e6                # H100 L2 cache; timed inputs rotate past it
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
F32 = torch.float32
STEPS = 5                      # train steps on the main path
SEED = 0                       # of the synthetic batch
PIPE_LR = 1e-6                 # SGD-momentum step of the pipelined path
PATTERNS = ((2, 5), (), (0,))  # straggler sets of the chained parity checks
SERVE_SEQ = 4096               # prompt length of the serving path
SERVE_CODE = (4, 3, 1, 2)      # (n, d, s, m) of the serving path
SERVE_BATCHES = 3              # batches the serve phase submits and steps
# decoded logits against the uncoded forward: f32 throughout, 28 layers of
# products summed in other orders (one prompt a call against four), then the
# decode's weights; held to 1e-3 of the largest logit
SERVE_REL_TOL = 1e-3
LM_SEQ = 4096                  # tokens a sequence on the LM training path
LM_CODE = (4, 3, 1, 2)         # (n, d, s, m): one sequence a subset
LM_STEPS = 3                   # steps of each LM training path
LM_NAG_LR = 1e-3               # NAG step of the synchronous LM path
LM_SGD_LR = 1e-3               # SGD-momentum step of the pipelined LM path
# the decoded gradient with a straggler against the uncoded one: f32, the
# decode's float64-solved weights applied in f32 to sums of 3 subsets
LM_GRAD_REL_TOL = 1e-4
CKPT_BATCH = 64                # global batch of the checkpoint phase's run
CKPT_STEPS = 6                 # steps of its uninterrupted run
CKPT_EVERY = 2                 # a snapshot every 2 steps: 2, 4 and 6
GEN_BATCH = 4                  # prompts of the generate phase
GEN_PROMPT = 4096              # tokens a prompt
GEN_NEW = 32                   # greedy tokens a prompt
GEN_CHECKED = (0, 1, GEN_NEW - 1)   # decode steps held against the forward
# decode logits against the full-prompt forward with the same attention
# math (the materialized f32 softmax at every length, as the reference's
# branch below 2048 tokens): f32, products of other shapes
# (tests/test_models_math.py's tolerance).  The forward through the flash
# kernel (3xTF32) is printed beside it: at 28 layers it is itself 2.9e-4
# from the materialized one (tools/decode_vs_forward.py, PERF.md)
GEN_TOL = 2e-4
RUN_LAUNCHES = 64              # back-to-back launches of one timed run
HOST_CALLS = 200               # calls of one host-cost measurement

torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in full f32
torch.backends.cudnn.allow_tf32 = False


def say(**obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ kernels
def _randn(gen, shape, dtype):
    return torch.randn(*shape, generator=gen).to(dtype).to(DEV)


def _offset_copy(x):
    """``x``'s values in a contiguous view whose base lies one element past
    an aligned allocation: the coding kernels' scalar path."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _serve_codec_shapes(code_nsdm=SERVE_CODE):
    """The serving path's encode ``G (1, q, m)`` and decode ``(n, L, m)``:
    one request a subset, its ``(vocab,)`` logits folded m-fold, and the
    wire of k blocks of q rounded up to lcm(WIRE_ALIGN, n), as
    ``make_coded_forward`` lays them out."""
    code = make_code(*code_nsdm)
    q = -(-get_config("qwen3-1.7b").vocab // code.m)
    align = math.lcm(coding.WIRE_ALIGN, code.n)
    L = -(-(code.num_subsets * q) // align) * align
    return (1, q, code.m), (code.n, L, code.m)


SERVE_ENC, SERVE_DEC = _serve_codec_shapes()
ENC2D = [(1, 8, 1), (3, 64, 2), (5, 640, 4), (8, 1024, 8), (31, 96, 3),
         (2, 1001, 7), (1, 171737, 2), SERVE_ENC]
ENC3D = [(3, 16, 2, 128), (4, 256, 2, 64), (2, 40, 5, 96), (2, 7, 3, 33),
         (1, 3072, 2, 2048)]
DEC2D = [(4, 64, 2), (16, 512, 3), (32, 96, 8), (10, 1280, 1), (12, 1001, 19),
         (64, 77, 32), (8, 171776, 2), SERVE_DEC]
DEC3D = [(4, 32, 2, 128), (16, 128, 4, 64), (5, 9, 11, 17), (8, 3072, 2048)]
ACC2D = [(1, 8, 1), (3, 64, 2), (5, 640, 4), (2, 1001, 7), (1, 171737, 2)]
ACC3D = [(2, 7, 3, 33), (2, 40, 5, 96), (3, 16, 2, 128), (1, 3072, 2, 2048)]
APPLY = [(4, 64, 2), (8, 1001, 3), (16, 512, 8), (5, 77, 11), (3, 300, 1),
         (8, 171776, 2)]                                    # (n, L, m)
HYPER = {"lr": 1e-2, "momentum": 0.9, "scale": 0.25}


def _einsum(kernel, a, b, out_dtype):
    """One library call for the same contraction: an independent witness of
    the kernels, and the ``library_ms`` yardstick."""
    if kernel is coded_encode:
        sub = "jvur,ju->vr" if a.dim() == 4 else "jvu,ju->v"
    else:
        sub = "nvr,nu->vur" if a.dim() == 3 else "nv,nu->vu"
    return torch.einsum(sub, a.to(F32), b.to(F32)).to(out_dtype or a.dtype)


def _compare(kernel, plain, a, b, out_dtype, dtype):
    """(max abs, max rel) error against the plain version, and max abs
    error against ``torch.einsum``; fails past the output type's tolerance."""
    got = kernel(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = plain(a, b, out_dtype=out_dtype)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{kernel.__name__}{tuple(a.shape)}: shape/dtype "
             f"{got.shape}/{got.dtype} != {want.shape}/{want.dtype}")
    if not torch.isfinite(got.to(F32)).all():
        fail(f"{kernel.__name__}{tuple(a.shape)}: non-finite output")
    diff = (got.to(F32) - want.to(F32)).abs()
    # both sides add the same f32 products in the same order (the kernel
    # with fused multiply-add), so the output type sets the tolerance
    tol = TOL[got.dtype]
    allowed = tol + tol * want.to(F32).abs()
    if (diff > allowed).any():
        fail(f"{kernel.__name__}{tuple(a.shape)} {dtype}->{got.dtype}: max abs "
             f"err {diff.max().item():.3e} exceeds atol=rtol={tol}")
    rel = (diff / want.to(F32).abs().clamp_min(1.0)).max().item()
    # the library's contraction adds in an order of its own
    lib = _einsum(kernel, a, b, out_dtype).to(F32)
    ldiff = (got.to(F32) - lib).abs()
    if (ldiff > tol + tol * lib.abs()).any():
        fail(f"{kernel.__name__}{tuple(a.shape)} {dtype}->{got.dtype}: max abs "
             f"err {ldiff.max().item():.3e} against torch.einsum exceeds "
             f"atol=rtol={tol}")
    return diff.max().item(), rel, ldiff.max().item()


def check_kernels():
    """Every variant against its plain version and against ``torch.einsum``;
    returns per-kernel max errors over the f32 cases (the bf16 cases are
    held to their own tolerance and reported apart)."""
    gen = torch.Generator().manual_seed(0)
    fused = ("coded_encode_acc_2d", "coded_encode_acc_3d", "coded_decode_apply")
    errs = {k: ({"max_abs_err": 0.0, "max_abs_err_bf16": 0.0, "cases": 0}
                if k in fused else
                {"max_abs_err": 0.0, "max_rel_err": 0.0,
                 "max_abs_err_vs_einsum": 0.0, "max_abs_err_bf16": 0.0,
                 "max_abs_err_bf16_vs_einsum": 0.0, "cases": 0})
            for k in ops.launch_counts() if k != "flash_attention"}

    def note(name, dtype, e):
        r = errs[name]
        r["cases"] += 1
        if dtype == F32:
            r["max_abs_err"] = max(r["max_abs_err"], e[0])
            r["max_rel_err"] = max(r["max_rel_err"], e[1])
            r["max_abs_err_vs_einsum"] = max(r["max_abs_err_vs_einsum"], e[2])
        else:
            r["max_abs_err_bf16"] = max(r["max_abs_err_bf16"], e[0])
            r["max_abs_err_bf16_vs_einsum"] = max(
                r["max_abs_err_bf16_vs_einsum"], e[2])

    for dtype in (F32, torch.bfloat16):
        for out_dtype in (None, F32):
            for shape in ENC2D + ENC3D:
                G = _randn(gen, shape, dtype)
                C = _randn(gen, (shape[0], shape[2]), dtype)
                name = "coded_encode_3d" if len(shape) == 4 else "coded_encode_2d"
                note(name, dtype, _compare(coded_encode, coded_encode_plain,
                                           G, C, out_dtype, dtype))
                # the scalar path (G one element off an aligned base) gives
                # the aligned call's bits
                got = coded_encode(G, C, out_dtype=out_dtype)
                G1 = _offset_copy(G)
                if encode_path(G1, got) != "scalar" or not torch.equal(
                        coded_encode(G1, C, out_dtype=out_dtype), got):
                    fail(f"coded_encode{shape} {dtype}: the scalar path "
                         f"differs from the {encode_path(G, got)} path bitwise")
                errs[name]["paths_bitwise_cases"] = \
                    errs[name].get("paths_bitwise_cases", 0) + 1
            for shape, m in [(s[:2], s[2]) for s in DEC2D] + \
                            [((s[0], s[1], s[3]), s[2]) if len(s) == 4
                             else (s, 2) for s in DEC3D]:
                Fm = _randn(gen, shape, dtype)
                W = _randn(gen, (shape[0], m), dtype)
                name = "coded_decode_3d" if len(shape) == 3 else "coded_decode_2d"
                note(name, dtype, _compare(coded_decode, coded_decode_plain,
                                           Fm, W, out_dtype, dtype))
                if len(shape) == 3:
                    continue
                # the 2D scalar path (F one element off an aligned base)
                # gives the aligned call's bits
                got = coded_decode(Fm, W, out_dtype=out_dtype)
                F1 = _offset_copy(Fm)
                if decode_path(F1, got) != "scalar" or not torch.equal(
                        coded_decode(F1, W, out_dtype=out_dtype), got):
                    fail(f"coded_decode{shape} {dtype}: the scalar path "
                         f"differs from the {decode_path(Fm, got)} path bitwise")
                errs[name]["paths_bitwise_cases"] = \
                    errs[name].get("paths_bitwise_cases", 0) + 1
    # what the wrappers must refuse on the card
    G = _randn(gen, (2, 64, 2), F32)
    for bad in (lambda: coded_encode(G.transpose(1, 2).contiguous().transpose(1, 2),
                                     G[:, 0]),
                lambda: coded_encode(G.double(), G[:, 0]),
                lambda: coded_decode(G[0], torch.zeros(64, 2))):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        fail("a wrapper accepted an operand the kernel does not take")
    check_fused_kernels(gen, errs)
    errs["flash_attention"] = check_flash(gen)
    return errs


def _close(what, got, want, tol):
    """Max abs error of ``got`` against ``want``; fails past atol=rtol=tol."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: shape/dtype {got.shape}/{got.dtype} != "
             f"{want.shape}/{want.dtype}")
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite output")
    diff = (got - want).abs()
    if (diff > tol + tol * want.abs()).any():
        fail(f"{what}: max abs err {diff.max().item():.3e} exceeds "
             f"atol=rtol={tol}")
    return diff.max().item()


def check_fused_kernels(gen, errs):
    """The pipelined step's kernels against their plain versions (ragged
    sweeps, G / F in f32 and bf16, acc / P / MU in f32), in place as
    promised, and bit for bit against the two-step spellings the
    synchronous step runs on the card: ``acc + coded_encode(G, C, f32)``,
    and ``coded_decode`` followed by the ``sgd_momentum`` expressions."""
    def note(name, dtype, e):
        r = errs[name]
        r["cases"] += 1
        key = "max_abs_err" if dtype == F32 else "max_abs_err_bf16"
        r[key] = max(r[key], e)

    for dtype in (F32, torch.bfloat16):
        for shape in ACC2D + ACC3D:
            G = _randn(gen, shape, dtype)
            C = _randn(gen, (shape[0], shape[2]), F32)
            out_shape = (shape[1], shape[3]) if len(shape) == 4 else (shape[1],)
            acc0 = _randn(gen, out_shape, F32)
            acc = acc0.clone()
            got = coded_encode_acc(acc, G, C)
            torch.cuda.synchronize()
            what = f"coded_encode_acc{tuple(shape)} {dtype}"
            if got.data_ptr() != acc.data_ptr():
                fail(f"{what}: the result is not acc, updated in place")
            e = _close(what, got, coded_encode_acc_plain(acc0, G, C), TOL[dtype])
            if not torch.equal(got, acc0 + coded_encode(G, C, out_dtype=F32)):
                fail(f"{what}: differs from acc + coded_encode(G, C) bitwise")
            # the scalar path, G or acc one element off an aligned base
            for G_, acc_ in ((_offset_copy(G), acc0.clone()),
                             (G, _offset_copy(acc0))):
                if encode_path(G_, acc_) != "scalar" or not torch.equal(
                        coded_encode_acc(acc_, G_, C), got):
                    fail(f"{what}: the scalar path differs from the "
                         f"{encode_path(G, acc)} path bitwise")
            name = "coded_encode_acc_3d" if len(shape) == 4 else "coded_encode_acc_2d"
            note(name, dtype, e)
            errs[name]["paths_bitwise_cases"] = \
                errs[name].get("paths_bitwise_cases", 0) + 2
        for n, L, m in APPLY:
            F = _randn(gen, (n, L), dtype)
            W = _randn(gen, (n, m), F32)
            P0, MU0 = _randn(gen, (L, m), F32), _randn(gen, (L, m), F32)
            P, MU = P0.clone(), MU0.clone()
            pn, mun, ss = coded_decode_apply(F, W, P, MU, **HYPER)
            torch.cuda.synchronize()
            what = f"coded_decode_apply{(n, L, m)} {dtype}"
            if pn.data_ptr() != P.data_ptr() or mun.data_ptr() != MU.data_ptr():
                fail(f"{what}: p' and mu' are not P and MU, updated in place")
            wp, wmu, wss = coded_decode_apply_plain(F, W, P0, MU0, **HYPER)
            e = max(_close(what + " p'", pn, wp, TOL[dtype]),
                    _close(what + " mu'", mun, wmu, TOL[dtype]))
            ss_rel = abs(ss.item() - wss.item()) / max(wss.item(), 1e-30)
            if ss.shape != () or ss_rel > 1e-5:
                fail(f"{what}: sum g^2 {ss.item()} vs plain {wss.item()} "
                     f"(rel {ss_rel:.3e} > 1e-5)")
            g = coded_decode(F, W, out_dtype=F32) * HYPER["scale"]
            mu = HYPER["momentum"] * MU0 + g
            if not (torch.equal(mun, mu) and torch.equal(pn, P0 - HYPER["lr"] * mu)):
                fail(f"{what}: p', mu' differ from coded_decode + the "
                     f"sgd_momentum expressions bitwise")
            again = coded_decode_apply(F, W, P0.clone(), MU0.clone(), **HYPER)[2]
            if not torch.equal(again, ss):
                fail(f"{what}: sum g^2 differs from run to run")
            # the scalar path (F, P or MU one element off an aligned base)
            # gives the aligned call's p' and mu' bit for bit
            for F_, P_, MU_ in ((_offset_copy(F), P0.clone(), MU0.clone()),
                                (F, _offset_copy(P0), MU0.clone()),
                                (F, P0.clone(), _offset_copy(MU0))):
                if apply_path(F_, P_, MU_) != "scalar":
                    fail(f"{what}: an offset operand kept the vector path")
                p1, mu1, _ = coded_decode_apply(F_, W, P_, MU_, **HYPER)
                if not (torch.equal(p1, pn) and torch.equal(mu1, mun)):
                    fail(f"{what}: the scalar path differs from the "
                         f"{apply_path(F, P0, MU0)} path bitwise")
            note("coded_decode_apply", dtype, e)
            r = errs["coded_decode_apply"]
            r["max_rel_err_sum_g2"] = max(r.get("max_rel_err_sum_g2", 0.0), ss_rel)
            r["paths_bitwise_cases"] = r.get("paths_bitwise_cases", 0) + 3
    errs["coded_decode_apply"]["device_kernels_per_call"] = _apply_kernels_per_call(gen)
    # what the fused wrappers must refuse on the card, and a CPU tensor
    # takes the plain version without a launch
    G = _randn(gen, (1, 64, 2), F32)
    C = _randn(gen, (1, 2), F32)
    F = _randn(gen, (4, 128), F32)
    W = _randn(gen, (4, 2), F32)
    shared = torch.zeros(4 * 128 + 256, device=DEV)
    for exc, bad in (
            (TypeError, lambda: coded_encode_acc(
                torch.zeros(64, device=DEV, dtype=torch.bfloat16), G, C)),
            (ValueError, lambda: coded_encode_acc(
                torch.zeros(128, device=DEV)[::2], G, C)),
            (ValueError, lambda: coded_decode_apply(
                F, W, torch.zeros(128, 2, device=DEV).t().contiguous().t(),
                torch.zeros(128, 2, device=DEV), **HYPER)),
            (AssertionError, lambda: coded_decode_apply(
                shared[:512].view(4, 128), W, shared[256:512].view(128, 2),
                torch.zeros(128, 2, device=DEV), **HYPER))):
        try:
            bad()
        except exc:
            continue
        fail(f"a fused wrapper accepted an operand it must refuse ({exc.__name__})")
    before = ops.launch_counts()
    coded_encode_acc(torch.zeros(64), G.cpu(), C.cpu())
    coded_decode_apply(F.cpu(), W.cpu(), torch.zeros(128, 2),
                       torch.zeros(128, 2), **HYPER)
    if ops.launch_counts() != before:
        fail("a CPU tensor launched a kernel")


def _apply_kernels_per_call(gen):
    """The device kernels of one ``coded_decode_apply`` call at the main
    path's bucket, as ``torch.profiler`` records them (after a warm call, so
    the stream's counter exists): the fused pass and the sum of the partials
    are one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n, L, m = APPLY[-1]
    args = (_randn(gen, (n, L), F32), _randn(gen, (n, m), F32),
            _randn(gen, (L, m), F32), _randn(gen, (L, m), F32))
    coded_decode_apply(*args, **HYPER)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        coded_decode_apply(*args, **HYPER)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if len(kernels) != 1 or "decode2d_kernel" not in kernels[0]:
        fail(f"coded_decode_apply ran {len(kernels)} device kernels a call, "
             f"not one: {kernels}")
    return len(kernels)


# (B, S, H, Hkv, hd, mask_kind, window, query offset): the sweep of
# tests/test_kernels.py, the serving shape, a window and a query offset; then
# the edges of the tensor-core kernel: hd 32 and 64 with a ragged S (a last
# key tile and query tile cut short), q_per_kv = 4, and B > 1 with a window
# and a query offset
FLASH = [(2, 256, 4, 2, 64, "causal", 0, 0), (1, 128, 2, 2, 32, "full", 0, 0),
         (2, 256, 4, 4, 64, "window", 64, 0), (1, 192, 4, 1, 128, "causal", 0, 0),
         (1, SERVE_SEQ, 16, 8, 128, "causal", 0, 0),
         (1, 1024, 16, 8, 128, "window", 256, 0),
         (2, 200, 8, 2, 128, "causal", 0, 312),
         (1, 200, 4, 2, 32, "causal", 0, 0), (1, 200, 4, 2, 64, "causal", 0, 0),
         (1, 256, 8, 2, 128, "causal", 0, 0),
         (2, 300, 4, 2, 64, "window", 96, 40)]
# q, k, v as views of one fused projection (B, S, H + 2 Hkv, hd): strided
# heads and rows, read in place by TMA
FLASH_FUSED = (2, 320, 8, 2, 128)
# the backward's own edges on top of FLASH: an S that is no multiple of its
# 32- or 64-row tiles at hd 128, q_per_kv = 4 with a window and a query
# offset, and hd 32 (64-byte rows for bf16) with q_per_kv = 4 and a window
FLASH_BWD_EDGES = [(1, 1000, 16, 8, 128, "causal", 0, 0),
                   (2, 97, 8, 2, 64, "window", 33, 5),
                   (1, 160, 8, 2, 32, "window", 48, 16)]


FLASH_BF16_REL_NORM = 1e-2


def _flash_inputs(gen, case, dtype):
    """q, k, v of one case: fresh tensors, or (``case`` of FLASH_FUSED's
    length) views of one fused projection."""
    if len(case) == len(FLASH_FUSED):
        B, S, H, Hkv, hd = case
        qkv = _randn(gen, (B, S, H + 2 * Hkv, hd), dtype)
        return (qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:],
                ("causal", 0, 0))
    B, S, H, Hkv, hd, kind, w, p0 = case
    return (_randn(gen, (B, S, H, hd), dtype),
            _randn(gen, (B, S + p0, Hkv, hd), dtype),
            _randn(gen, (B, S + p0, Hkv, hd), dtype), (kind, w, p0))


def check_flash(gen):
    """``flash_attention`` against its plain version on the card (f32 and
    bf16), one launch a call; then what the wrapper must refuse."""
    r = {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0, "cases": 0}
    for dtype in (F32, torch.bfloat16):
        for case in FLASH + [FLASH_FUSED]:
            q, k, v, (kind, w, p0) = _flash_inputs(gen, case, dtype)
            H, Hkv = q.shape[2], k.shape[2]
            n0 = flash_attn.LAUNCHES["flash_attention"]
            got = flash_attn.flash_attention_gqa(q, k, v, H // Hkv,
                                                 mask_kind=kind, window=w,
                                                 kv_pos0=p0)
            torch.cuda.synchronize()
            if flash_attn.LAUNCHES["flash_attention"] != n0 + 1:
                fail("flash_attention did not launch its kernel once")
            want = flash_attn.flash_attention_gqa_plain(
                q, k, v, H // Hkv, mask_kind=kind, window=w, kv_pos0=p0)
            what = f"flash_attention{case} {dtype}"
            if got.dtype != dtype:
                fail(f"{what}: output dtype {got.dtype}")
            e = _close(what, got.to(F32), want.to(F32), TOL[dtype])
            key = "max_abs_err" if dtype == F32 else "max_abs_err_bf16"
            r[key] = max(r[key], e)
            if dtype == torch.bfloat16:
                # at long S the outputs are small (about 0.03 for S = 4096),
                # so the elementwise 2e-2 alone is loose: the error's norm
                # is held to 1e-2 of the output's as well
                rel = ((got.float() - want.float()).norm() /
                       want.float().norm()).item()
                if rel > FLASH_BF16_REL_NORM:
                    fail(f"{what}: relative error norm {rel:.3e} exceeds "
                         f"{FLASH_BF16_REL_NORM}")
                r["max_rel_norm_err_bf16"] = max(
                    r.get("max_rel_norm_err_bf16", 0.0), rel)
            r["cases"] += 1
    x = _randn(gen, (1, 64, 2, 48), F32)
    y = _randn(gen, (1, 64, 2, 64), F32)
    # TMA takes bases and strides in multiples of 16 bytes: a head stride of
    # 66 floats, and a base 4 bytes past an aligned one, are refused
    odd_stride = _randn(gen, (1, 64, 2, 66), F32)[..., :64]
    odd_base = _randn(gen, (64 * 2 * 64 + 1,), F32)[1:].view(1, 64, 2, 64)
    needs_grad = y.clone().requires_grad_()
    for exc, bad in ((ValueError, lambda: flash_attn.flash_attention_gqa(x, x, x, 1)),
                     (TypeError, lambda: flash_attn.flash_attention_gqa(
                         y, y.bfloat16(), y, 1)),
                     (ValueError, lambda: flash_attn.flash_attention_gqa(
                         _randn(gen, (1, 64, 2, 128), F32)[..., ::2], y, y, 1)),
                     (ValueError, lambda: flash_attn.flash_attention_gqa(
                         odd_stride, y, y, 1)),
                     (ValueError, lambda: flash_attn.flash_attention_gqa(
                         y, odd_base, y, 1))):
        n0 = flash_attn.LAUNCHES["flash_attention"]
        try:
            bad()
        except exc:
            if flash_attn.LAUNCHES["flash_attention"] != n0:
                fail("flash_attention launched on an operand it refused")
            continue
        fail(f"flash_attention accepted an operand it must refuse ({exc.__name__})")
    # under no_grad an input that requires grad runs the forward alone; under
    # grad mode the call is differentiable through the backward kernel
    with torch.no_grad():
        if flash_attn.flash_attention_gqa(needs_grad, y, y, 1).requires_grad:
            fail("flash_attention under no_grad returned a graph")
    b0 = flash_attn.LAUNCHES["flash_attention_bwd"]
    (got,) = torch.autograd.grad(
        flash_attn.flash_attention_gqa(needs_grad, y, y, 1), needs_grad, y)
    ref = y.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        flash_attn.flash_attention_gqa_plain(ref, y, y, 1), ref, y)
    torch.cuda.synchronize()
    if flash_attn.LAUNCHES["flash_attention_bwd"] != b0 + 1:
        fail("a grad-mode flash_attention did not launch its backward once")
    _close("flash_attention grad under grad mode", got, want, 1e-4)
    return r


# The backward's tolerances against the plain version's autograd (TF32 off):
# the kernel runs its products as 3xTF32 (about 1e-6 relative) and sums in
# f32 in other orders than the plain loop's einsums, over up to S keys; bf16
# against autograd through bf16 products (the plain version rounds P and
# the products to bf16, the kernel P and dS)
FLASH_BWD_REL_NORM = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FLASH_BWD_MAX_ABS_OF_MAX = 1e-4      # f32: max |err| over max |plain grad|


def _flash_grads(fn, q, k, v, dout, g, kind, w, p0):
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, g, mask_kind=kind, window=w, kv_pos0=p0)
    return torch.autograd.grad(out, leaves, dout)


def check_flash_bwd(gen):
    """The backward kernel against the plain version's autograd on the
    card over the forward's sweep (the 4096-token serve shape with
    q_per_kv = 2, a window, query offsets, hd 32 and 64 with ragged S, views
    of one fused projection) and the backward's edges (FLASH_BWD_EDGES), f32
    and bf16: one backward launch a call; the same bits on a second call (no
    atomics); and the forward's output with the log-sum-exp residual written
    bitwise the output without it."""
    r = {"max_abs_err": 0.0, "max_rel_norm_err": 0.0,
         "max_rel_norm_err_bf16": 0.0, "cases": 0}
    for dtype in (F32, torch.bfloat16):
        for case in FLASH + FLASH_BWD_EDGES + [FLASH_FUSED]:
            q, k, v, (kind, w, p0) = _flash_inputs(gen, case, dtype)
            g = q.shape[2] // k.shape[2]
            dout = _randn(gen, tuple(q.shape), dtype)
            what = f"flash_attention_bwd{case} {dtype}"
            out0 = flash_attn._forward(q, k, v, kind, w, p0, residual=False)[0]
            out, lse = flash_attn._forward(q, k, v, kind, w, p0, residual=True)
            if not torch.equal(out0, out):
                fail(f"{what}: writing the residual changed the forward's bits")
            n0 = flash_attn.LAUNCHES["flash_attention_bwd"]
            p_0 = flash_attn.PLAIN_CALLS["flash_attention"]
            got = _flash_grads(flash_attn.flash_attention_gqa, q, k, v, dout,
                               g, kind, w, p0)
            torch.cuda.synchronize()
            if (flash_attn.LAUNCHES["flash_attention_bwd"] != n0 + 1
                    or flash_attn.PLAIN_CALLS["flash_attention"] != p_0):
                fail(f"{what}: not one backward launch, or a plain call")
            again = flash_attn.flash_attention_bwd(
                q, k, v, out, lse, dout, mask_kind=kind, window=w, kv_pos0=p0)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{what}: two calls gave other bits")
            want = _flash_grads(flash_attn.flash_attention_gqa_plain, q, k, v,
                                dout, g, kind, w, p0)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                if a.dtype != dtype or a.shape != b.shape:
                    fail(f"{what} {name}: {a.dtype} {tuple(a.shape)}")
                a, b = a.float(), b.float()
                if not torch.isfinite(a).all():
                    fail(f"{what} {name}: non-finite")
                rel = ((a - b).norm() / b.norm()).item()
                if rel > FLASH_BWD_REL_NORM[dtype]:
                    fail(f"{what} {name}: relative error norm {rel:.3e} "
                         f"exceeds {FLASH_BWD_REL_NORM[dtype]}")
                if dtype == F32:
                    err = (a - b).abs().max().item()
                    if err > FLASH_BWD_MAX_ABS_OF_MAX * b.abs().max().item():
                        fail(f"{what} {name}: max abs err {err:.3e} exceeds "
                             f"{FLASH_BWD_MAX_ABS_OF_MAX} of max |plain|")
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    r["max_rel_norm_err"] = max(r["max_rel_norm_err"], rel)
                else:
                    r["max_rel_norm_err_bf16"] = max(
                        r["max_rel_norm_err_bf16"], rel)
            r["cases"] += 1
    r["tolerance"] = {"f32_rel_norm": 1e-5,
                      "f32_max_abs_of_max": FLASH_BWD_MAX_ABS_OF_MAX,
                      "bf16_rel_norm": 2e-2}
    return r


def time_ms(fn, reps=25, warmup=5):
    """Median device time of one call ``fn(i)``: CUDA events around the
    call, queued behind a spin kernel so the host's enqueue cost is not in
    the span.  ``i`` counts the calls, so the caller can hand each call
    another copy of its inputs."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(warmup + len(times))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_run_ms(fn, launches=RUN_LAUNCHES, reps=5, warmup=3):
    """Median device time per call over a run of ``launches`` back-to-back
    calls ``fn(i)`` between one pair of CUDA events.  The run is queued
    behind a spin kernel; if the device reached the run's start before the
    host had queued all of it (host gaps inside the span), the spin is
    doubled and the run taken again.  ``i`` keeps counting across runs, so
    rotating operands never repeat within a cache's reach."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    spin, i, times = 4_000_000, warmup, []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(launches):
            fn(i)
            i += 1
        end.record()
        covered = not start.query()
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end) / launches)
        elif spin > 1 << 32:
            fail("the host could not queue a run of launches ahead of the card")
        else:
            spin *= 2
    return statistics.median(times)


def host_us_per_call(fn, calls=HOST_CALLS, reps=5):
    """Host microseconds per call of ``fn()``: the host clock over
    ``calls`` calls with no sync between them, then one sync outside the
    span (the device's time is not in it unless the launch queue fills);
    median of ``reps`` such spans, as the host is shared."""
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        spans.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(spans) / calls * 1e6


def measure_launch_floor():
    """The launch floor: an empty kernel of the built library (one block,
    no work), timed as one launch and as a run of back-to-back launches,
    and its host cost per call through the same ``ctypes`` path."""
    def empty(*_):
        _launch.call("empty_kernel_launch", DEV)
    return {"ms": time_ms(empty), "ms_per_launch_run": time_run_ms(empty),
            "run_launches": RUN_LAUNCHES, "host_us_per_call": host_us_per_call(empty)}


def _bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _operands(kind, shape, m, dtype, out_dtype, gen):
    """What one timed call of ``kind`` needs: a maker of the operands that
    rotate past the L2, the kernel, the plain version and the library call
    (None where no single PyTorch call computes the same function) on those
    operands, and the bytes and operations that bound it."""
    isz = torch.empty((), dtype=dtype).element_size()
    osz = torch.empty((), dtype=out_dtype).element_size()
    if kind == "flash":
        return _flash_operands(shape, dtype, gen, isz)
    if kind == "flash_bwd":
        return _flash_bwd_operands(shape, dtype, gen, isz)
    n_in = int(np.prod(shape))
    if kind in ("encode", "encode_acc"):
        d, V, mm = shape[:3]
        R = shape[3] if len(shape) == 4 else 1
        coef = _randn(gen, (d, mm), F32)
        acc_shape = (V, R) if len(shape) == 4 else (V,)
        if kind == "encode":
            return ((lambda: (_randn(gen, shape, dtype),)),
                    lambda o: coded_encode(o[0], coef, out_dtype=out_dtype),
                    lambda o: coded_encode_plain(o[0], coef, out_dtype=out_dtype),
                    lambda o: _einsum(coded_encode, o[0], coef, out_dtype),
                    n_in * isz + V * R * osz, 2 * n_in)
        if d != 1:
            raise ValueError("the library yardstick of encode_acc takes d = 1")
        # one call for acc + G C with d = 1: a gemv (2D), a batched gemm
        # with one row per v (3D)
        lib = ((lambda o: torch.addmv(o[1], o[0][0], coef[0]))
               if len(shape) == 3 else
               (lambda o: torch.baddbmm(o[1][:, None, :],
                                        coef[0].expand(V, 1, mm), o[0][0])))
        return ((lambda: (_randn(gen, shape, dtype), _randn(gen, acc_shape, F32))),
                lambda o: coded_encode_acc(o[1], o[0], coef),
                lambda o: coded_encode_acc_plain(o[1], o[0], coef),
                lib, n_in * isz + 2 * V * R * 4, 2 * n_in + V * R)
    if kind == "decode":
        coef = _randn(gen, (shape[0], m), F32)
        return ((lambda: (_randn(gen, shape, dtype),)),
                lambda o: coded_decode(o[0], coef, out_dtype=out_dtype),
                lambda o: coded_decode_plain(o[0], coef, out_dtype=out_dtype),
                lambda o: _einsum(coded_decode, o[0], coef, out_dtype),
                n_in * isz + n_in // shape[0] * m * osz, 2 * n_in * m)
    n, L = shape
    W = _randn(gen, (n, m), F32)
    hy = {"lr": PIPE_LR, "momentum": 0.9, "scale": 1.0}
    return ((lambda: (_randn(gen, shape, dtype), _randn(gen, (L, m), F32),
                      _randn(gen, (L, m), F32))),
            lambda o: coded_decode_apply(o[0], W, o[1], o[2], **hy),
            lambda o: coded_decode_apply_plain(o[0], W, o[1], o[2], **hy),
            None,                # decode + momentum + update: no one call
            n_in * isz + 4 * L * m * 4, 2 * n_in * m + 6 * L * m)


def _flash_operands(shape, dtype, gen, isz):
    """Causal attention at ``(B, S, H, Hkv, hd)``: the kernel, the plain
    version and ``scaled_dot_product_attention`` in the same type (the
    yardstick; the port never calls it) on the same q, k, v.  Operations:
    the pairs the causal mask admits, S (S + 1) / 2 per head, times 2 hd for
    the scores and 2 hd for P V; bytes: q, k, v read once, the output
    written once."""
    B, S, H, Hkv, hd = shape
    g = H // Hkv

    def make():
        return (_randn(gen, (B, S, H, hd), dtype),
                _randn(gen, (B, S, Hkv, hd), dtype),
                _randn(gen, (B, S, Hkv, hd), dtype))

    def library(o):
        q, k, v = (x.transpose(1, 2) for x in o)
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=g > 1)

    nbytes = (2 * B * S * H * hd + 2 * B * S * Hkv * hd) * isz
    flops = 4 * hd * B * H * S * (S + 1) // 2
    return (make, lambda o: flash_attn.flash_attention_gqa(*o, g),
            lambda o: flash_attn.flash_attention_gqa_plain(*o, g),
            library, nbytes, flops)


def _flash_bwd_operands(shape, dtype, gen, isz):
    """The causal backward at ``(B, S, H, Hkv, hd)``: the kernels on a
    forward's output and residual; the plain version's autograd backward
    and ``scaled_dot_product_attention``'s backward in the same type (the
    yardstick; the port never calls it), each on a graph built once and
    kept.  Operations: the five products of the gradient over the pairs
    the causal mask admits (S, dP, dV, dQ, dK), 2 hd each a pair and head;
    bytes: q, k, v, o, dO and the residual read once, dq, dk, dv written
    once."""
    B, S, H, Hkv, hd = shape
    g = H // Hkv

    def make():
        q = _randn(gen, (B, S, H, hd), dtype)
        k = _randn(gen, (B, S, Hkv, hd), dtype)
        v = _randn(gen, (B, S, Hkv, hd), dtype)
        dout = _randn(gen, (B, S, H, hd), dtype)
        out, lse = flash_attn._forward(q, k, v, "causal", 0, 0, residual=True)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        plain = flash_attn.flash_attention_gqa_plain(*leaves, g)
        sdpa_leaves = [x.transpose(1, 2).clone().requires_grad_()
                       for x in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            *sdpa_leaves, is_causal=True, enable_gqa=g > 1)
        return (q, k, v, out, lse, dout, leaves, plain, sdpa_leaves, sdpa,
                dout.transpose(1, 2))

    def kernel(o):
        return flash_attn.flash_attention_bwd(*o[:6])

    def plain(o):
        return torch.autograd.grad(o[7], o[6], o[5], retain_graph=True)

    def library(o):
        return torch.autograd.grad(o[9], o[8], o[10], retain_graph=True)

    nbytes = (4 * B * S * H * hd + 4 * B * S * Hkv * hd) * isz + B * H * S * 4
    flops = 5 * 2 * hd * B * H * S * (S + 1) // 2
    return make, kernel, plain, library, nbytes, flops


def _paths_since(before, prefix):
    """Launches by kernel path since the path counts ``before``, summed
    over the variants whose names start with ``prefix``."""
    now = ops.path_counts()
    return {p: sum(now[k][p] - before[k][p] for k in now if k.startswith(prefix))
            for p in ("vector", "scalar")}


def measure(kind, shape, m=None, dtype=F32, out_dtype=F32, scalar=False):
    """ms / plain_ms / library_ms / bound_ms of one kernel at one shape
    (``scalar``: every operand one element off an aligned base, the coding
    kernels' scalar path).

    ``bound_ms`` takes the bytes from device memory, so the three times are
    read on inputs that are not in the L2 cache: each call gets the next of
    enough copies of the operands to pass twice the cache's size before one
    comes round again.  ``ms_l2_warm`` is the kernel on one copy, every
    call, as the train step finds an operand that was written just before.
    The in-place kernels update their copy on every call."""
    gen = torch.Generator().manual_seed(1)
    make, kernel, plain, library, nbytes, flops = _operands(
        kind, shape, m, dtype, out_dtype, gen)
    if scalar:
        aligned = make

        def make():
            return tuple(_offset_copy(x) for x in aligned())
    first = make()
    per_copy = sum(x.numel() * x.element_size() for x in first
                   if isinstance(x, torch.Tensor))
    copies = max(2, int(2 * L2_BYTES // per_copy) + 1)
    sets = [first] + [make() for _ in range(copies - 1)]
    # the coding kernels compute in f32 whatever the input type; the bf16
    # bound is the tensor cores' rate, the most the card offers for bf16.
    # Flash attention runs on the tensor cores: bf16 in one pass, f32 as
    # 3xTF32, three TF32 products for each one
    extra = {}
    if kind in ("flash", "flash_bwd") and dtype == F32:
        bound_ms, bound_by = _bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
        extra["bound_ms_f32_cuda_cores"] = _bound(nbytes, flops)[0]
    else:
        bound_ms, bound_by = _bound(nbytes, flops,
                                    BF16_FLOP_PER_S if dtype == torch.bfloat16
                                    else F32_FLOP_PER_S)
    paths0 = ops.path_counts()
    ms = time_ms(lambda i: kernel(sets[i % copies]))
    if kind in ("encode", "encode_acc", "decode_apply") or (
            kind == "decode" and len(shape) == 2):
        prefix = "coded_decode" if kind.startswith("decode") else "coded_encode"
        extra["path"] = [p for p, n in _paths_since(paths0, prefix).items() if n]
    plain_ms = time_ms(lambda i: plain(sets[i % copies]))
    library_ms = (time_ms(lambda i: library(sets[i % copies]))
                  if library is not None else None)
    ms_warm = time_ms(lambda i: kernel(sets[0]))
    if not kind.startswith("flash"):
        # the coding kernels' launch-bound regime: a run of back-to-back
        # launches on rotating operands, and the host's cost per call
        extra["ms_per_launch_run"] = time_run_ms(lambda i: kernel(sets[i % copies]))
        extra["host_us_per_call"] = host_us_per_call(lambda: kernel(sets[0]))
    return {"shape": list(shape) + ([m] if m else []),
            "dtype": str(dtype).split(".")[-1],
            "out_dtype": str(out_dtype).split(".")[-1],
            "bytes": nbytes, "input_copies": copies, "ms": ms,
            "ms_l2_warm": ms_warm, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops,
            "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
            "achieved_TFLOPps": flops / (ms * 1e-3) / 1e12,
            "share_of_bound": bound_ms / ms, **extra}


_FLASH_ENTRY = re.compile(r"(flash_kernel|fb_kernel|fb_dot_kernel)I(f|13__nv_bfloat16)"
                          r"Li(\d+)E(?:Lb([01])E)?")


def flash_kernels_ptxas(report):
    """The flash kernels' lines of ``_build.ptxas_report()`` (registers and
    spill bytes), forward and backward, under readable names such as
    ``fb_kernel f32 hd128 dkdv``; fails when the build's log names none."""
    out = {}
    for name, info in report.items():
        m = _FLASH_ENTRY.search(name)
        if m:
            kind = {"1": " dkdv", "0": " dq"}.get(m.group(4), "")
            dtype = "f32" if m.group(2) == "f" else "bf16"
            out[f"{m.group(1)} {dtype} hd{m.group(3)}{kind}"] = info
    if not out:
        fail("the build's ptxas report names no flash kernel")
    return out


# ---------------------------------------------------------------- main path
def _mlp_case(gen_seed=21):
    """A two-layer MLP as a plain parameter dict: ``w1`` (6144, 2048) and
    ``w2`` (2048, 512) are grouped on dim 0 and keep a trailing dim, so their
    encodes go through the 3D kernel and, per leaf, so do their decodes."""
    rng = np.random.default_rng(gen_seed)

    def t(shape, scale):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(DEV)

    params = {"w1": t((6144, 2048), 0.01), "b": t((512,), 0.1),
              "w2": t((2048, 512), 0.02)}

    def loss_fn(p, batch):
        h = torch.tanh(batch["x"] @ p["w1"])
        return torch.sum((h @ p["w2"] + p["b"] - batch["t"]) ** 2)

    batch = {"x": t((128, 6144), 1.0), "t": t((128, 512), 1.0)}
    return params, loss_fn, batch


# ROADMAP C.3's leaf shapes: with code (4, 3, 1, 2) the a2a schedule cuts
# each encoding into one-element chunks
SMALL_TREES = ([(8,)], [(8,), (16,)])


def check_packed_per_leaf_small():
    """Packed == per-leaf bitwise on the card, on the kernel backend, for
    the C.3 trees, both schedules and both wire types (the CPU test
    ``test_decode_matches_reference_and_packed_is_bitwise_per_leaf`` holds
    the same on the plain versions), through ``make_coded_train_step``'s
    ``aggregate`` with a straggler; each result is also held to the plain
    backend on the card at the wire type's tolerance."""
    code = make_code(4, 3, 1, 2)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(8 * code.num_subsets, 16, generator=gen).to(DEV)
    placed = CodedBatcher(code).place({"x": x})

    def loss_fn(p, b):
        return sum(torch.sum(torch.sin(b["x"][:, :v.numel()] * v))
                   for v in p.values())

    def aggregate(params, schedule, wire, packed, backend):
        arts = make_coded_train_step(
            None, code, sgd_momentum(1e-3), loss_fn=loss_fn, params_like=params,
            grad_scale=1.0, spec=coding.SchemeSpec(packed=packed, schedule=schedule,
                                                   encode_dtype=wire, backend=backend))
        if arts.coded_fraction != 1.0:
            fail(f"C.3 tree {[tuple(v.shape) for v in params.values()]}: "
                 f"coded_fraction {arts.coded_fraction}")
        inp = arts.step_inputs((1,))
        return arts.aggregate(params, placed, inp["W"], inp["mask"], inp["rho"])[0]

    cases = []
    paths0 = ops.path_counts()
    for shapes in SMALL_TREES:
        params = {f"p{i}": (0.5 * torch.randn(s, generator=gen)).to(DEV)
                  for i, s in enumerate(shapes)}
        for schedule in ("gather", "a2a"):
            for wire in ("float32", "bfloat16"):
                before = ops.launch_counts()
                leaf = aggregate(params, schedule, wire, False, "auto")
                packed = aggregate(params, schedule, wire, True, "auto")
                now = ops.launch_counts()
                launched = {k: now[k] - before[k] for k in now if now[k] != before[k]}
                plain = aggregate(params, schedule, wire, True, "ref")
                torch.cuda.synchronize()
                what = f"C.3 tree {shapes}, {schedule}, {wire} wire"
                if not (launched.get("coded_encode_2d") and launched.get("coded_decode_2d")):
                    fail(f"{what}: the kernels were not launched ({launched})")
                tol = TOL[torch.float32 if wire == "float32" else torch.bfloat16]
                for k in params:
                    if not torch.equal(leaf[k], packed[k]):
                        fail(f"{what}, leaf {k}: packed != per-leaf bitwise")
                    err = _rel_err(packed[k], plain[k])
                    if err > tol:
                        fail(f"{what}, leaf {k}: kernels vs plain backend {err:.3e}")
                cases.append({"shapes": [list(s) for s in shapes],
                              "schedule": schedule, "wire": wire,
                              "launches": launched})
    say(phase="checks_packed_small", packed_equals_per_leaf_bitwise=True,
        stragglers=[1], cases=cases,
        encode_launches_by_kernel_path=_paths_since(paths0, "coded_encode"),
        decode_launches_by_kernel_path=_paths_since(paths0, "coded_decode"))


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


KERNEL_PATHS = {}   # launches of each counted path by kernel path, of the
                    # kernels that have two (encodes, 2D decode, decode-apply)


def _note_paths(label, require_vector=True):
    """Record the launches of the path ``label`` by kernel path, read with
    its launch counts; fail if one of them left the vector path."""
    paths = {k: v for k, v in ops.path_counts().items() if v["vector"] or v["scalar"]}
    KERNEL_PATHS[label] = paths
    scalar = {k: v["scalar"] for k, v in paths.items() if v["scalar"]}
    if scalar and require_vector:
        fail(f"{label}: kernels took the scalar path {scalar}")
    return paths


def _expect(**launches):
    """Every kernel's expected launch count: the given ones, 0 elsewhere."""
    return {**{k: 0 for k in ops.launch_counts()}, **launches}


def _timed_steps(tr, batch, steps):
    """``steps`` Trainer steps, each with its wall time up to a device sync
    (a pipelined fill reports no metrics, so nothing else waits for it)."""
    logs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = tr.step(batch)
        torch.cuda.synchronize()
        m["wall_ms"] = (time.perf_counter() - t0) * 1e3
        logs.append(m)
    return logs


def _union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_steps(step, step_ms, label, steps=3):
    """Where a step's time goes (``step()`` runs one): ``torch.profiler``
    over a few more steps gives the device-busy time and the kernels that fill it; the idle
    share is taken against ``step_ms``, the step's wall time measured
    without the profiler (tracing slows the host many times over).  Busy
    time is the union of the device activities' intervals over all streams;
    ``stream_overlap_ms_per_step`` is the time two streams were busy at once
    (the pipelined step's side stream beside the current one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        fail("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    by_stream = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            by_stream.setdefault(e.device_resource_id, []).append(
                (e.time_range.start, e.time_range.end))
    union_ms = _union_us([iv for ivs in by_stream.values() for iv in ivs]) / 1e3
    per_stream = {str(k): _union_us(v) / 1e3 / steps for k, v in by_stream.items()}
    busy_ms = union_ms / steps
    idle = 1.0 - busy_ms / step_ms
    say(phase="profile", path=label, steps=steps, step_ms_unprofiled=step_ms,
        device_busy_ms_per_step=busy_ms,
        device_kernel_ms_per_step=sum(r[1] for r in rows) / steps,
        busy_ms_per_step_by_stream=per_stream,
        stream_overlap_ms_per_step=sum(per_stream.values()) - busy_ms,
        device_idle_share=idle,
        top_device_kernels=[{"name": k[:90], "ms_per_step": ms / steps,
                             "calls_per_step": c / steps}
                            for k, ms, c in rows[:12]])
    return idle


def pipelined_trainer(cfg, code, backend="auto"):
    return Trainer(cfg, code, optimizer=sgd_momentum(PIPE_LR, 0.9),
                   spec=coding.SchemeSpec(backend=backend, pipelined=True,
                                          fuse_apply=True),
                   straggler_source=RandomStragglers(seed=1), seed=0)


def run_pipelined_path(args, cfg, code, batch):
    """The pipelined fused ``Trainer`` at full width: 5 steps and a drain,
    counted from 0; then, outside the window, the synchronous SGD-momentum
    ``Trainer`` on the same batch for the step-time comparison."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = pipelined_trainer(cfg, code)
    logs = _timed_steps(tr, batch, STEPS)
    t0 = time.perf_counter()
    drained = tr.drain()
    torch.cuda.synchronize()
    drained["wall_ms"] = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    _note_paths("logistic-paper pipelined Trainer.step")
    peak = torch.cuda.max_memory_allocated()
    first, later = logs[0], logs[1:] + [drained]
    if not (np.isnan(first["loss"]) and np.isnan(first["grad_norm"])):
        fail(f"the fill step reported metrics: {first}")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in later):
        fail(f"non-finite pipelined metrics: {later}")
    losses = [m["loss"] for m in later]
    if not drained["loss"] < losses[0]:
        fail(f"pipelined loss does not decrease: {losses}")
    want = _expect(coded_encode_acc_2d=STEPS * code.n * code.d,
                   coded_decode_apply=STEPS - 1 + 1)
    if counts != want:
        fail(f"pipelined kernel launches {counts}, the steps should issue {want}")
    beta = tr.params["beta"]
    if beta.shape != (343474,) or not torch.isfinite(beta).all() or \
            beta.device.type != "cuda":
        fail("beta after the pipelined run: wrong shape, device or non-finite")
    sync = Trainer(cfg, code, optimizer=sgd_momentum(PIPE_LR, 0.9),
                   straggler_source=RandomStragglers(seed=1), seed=0)
    sync_logs = _timed_steps(sync, batch, STEPS)
    # the steady metric describes the previous batch: the first one reported
    # is the synchronous step's first
    if not np.isclose(losses[0], sync_logs[0]["loss"], rtol=1e-6, atol=0):
        fail(f"first reported pipelined loss {losses[0]} != the synchronous "
             f"step's {sync_logs[0]['loss']}")
    steady_ms = [m["wall_ms"] for m in logs[1:]]
    sync_ms = [m["wall_ms"] for m in sync_logs[1:]]
    say(phase="train_pipelined", model=cfg.name, l=cfg.d_model,
        code=[8, 4, 2, 2], global_batch=args.global_batch,
        optimizer="sgd_momentum", lr=PIPE_LR, momentum=0.9, schedule="gather",
        pipelined=True, fuse_apply=True, losses_reported=losses,
        grad_norm=[m["grad_norm"] for m in later],
        fill_ms=logs[0]["wall_ms"], steady_ms=steady_ms,
        drain_ms=drained["wall_ms"], sync_step_ms=[m["wall_ms"] for m in sync_logs],
        steady_ms_median=statistics.median(steady_ms),
        sync_ms_median_after_first=statistics.median(sync_ms),
        sync_losses=[m["loss"] for m in sync_logs], launches=counts,
        peak_memory_bytes=peak)
    return tr, counts, statistics.median(steady_ms), statistics.median(sync_ms)


def _device_batch(gen, rows, width):
    return {"x": torch.randn((rows, width), generator=gen, device=DEV),
            "y": (torch.rand(rows, generator=gen, device=DEV) < 0.5).to(torch.int32)}


def pipelined_checks(args, cfg, code, batch, tr_p):
    """On the card, kernels on both sides: fill + drain == the synchronous
    step bitwise over 3 chained batches and straggler patterns, fused and
    not; steady(b1, W0) retires exactly the synchronous update of b0; the
    pipelined run against the plain backend."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    batcher = CodedBatcher(code)
    placed = [batcher.place(b) for b in
              [batch] + [_device_batch(gen, args.global_batch, cfg.d_model)
                         for _ in range(2)]]
    opt = sgd_momentum(1e-4, 0.9)
    arts_s = make_coded_train_step(cfg, code, opt)
    beta0 = {"beta": 1e-3 * torch.randn(cfg.d_model, generator=gen, device=DEV)}
    gnorm_rel = {}
    for fuse in (False, True):
        arts_p = make_coded_train_step(
            cfg, code, opt,
            spec=coding.SchemeSpec(pipelined=True, fuse_apply=fuse))
        ps = pp = beta0
        os_ = op = opt.init(beta0)
        drv = PipelineDriver(arts_p)
        rel = 0.0
        for b, st in zip(placed, PATTERNS):
            inp = arts_s.step_inputs(st)
            a = (inp["W"], inp["mask"], inp["rho"])
            ps, os_, ms = arts_s.step(ps, os_, b, *a)
            pp, op, mp = drv.step(pp, op, b, *a)
            if mp is not None:
                fail("a pipelined fill returned metrics")
            pp, op, mp = drv.drain(pp, op)
            if not (torch.equal(ps["beta"], pp["beta"])
                    and torch.equal(os_["mu"]["beta"], op["mu"]["beta"])
                    and torch.equal(ms["loss"], mp["loss"])):
                fail(f"fill + drain (fuse_apply={fuse}) differs from the "
                     f"synchronous step bitwise at stragglers {st}")
            rel = max(rel, abs(mp["grad_norm"].item() / ms["grad_norm"].item() - 1))
            if (not fuse and not torch.equal(ms["grad_norm"], mp["grad_norm"])) \
                    or rel > 1e-5:
                fail(f"fill + drain (fuse_apply={fuse}) grad_norm off by {rel:.3e}")
        gnorm_rel[f"fuse_apply={fuse}"] = rel
        inp0, inp1 = arts_s.step_inputs((1,)), arts_s.step_inputs(())
        st0 = opt.init(beta0)
        wire = arts_p.pipeline.fill(beta0, placed[0], inp0["mask"], inp0["rho"])
        out = arts_p.pipeline.steady(beta0, st0, placed[1], inp0["W"],
                                     inp1["mask"], inp1["rho"], *wire)
        ps, os_, ms = arts_s.step(beta0, st0, placed[0], inp0["W"],
                                  inp0["mask"], inp0["rho"])
        torch.cuda.synchronize()
        if not (torch.equal(out[0]["beta"], ps["beta"])
                and torch.equal(out[1]["mu"]["beta"], os_["mu"]["beta"])
                and torch.equal(out[2]["loss"], ms["loss"])):
            fail(f"steady(b1, W0) (fuse_apply={fuse}) is not the synchronous "
                 f"update of b0 bitwise")
    ref = pipelined_trainer(cfg, code, backend="ref")
    _timed_steps(ref, batch, STEPS)
    ref.drain()
    want = ref.params["beta"]
    err = _rel_err(tr_p.params["beta"], want)
    if not torch.allclose(tr_p.params["beta"], want, rtol=1e-4,
                          atol=1e-4 * want.abs().max().item()):
        fail(f"pipelined beta: kernels vs plain backend differ by {err:.3e}")
    say(phase="checks_pipelined", fill_drain_bitwise=True,
        steady_retires_sync_update_bitwise=True, patterns=PATTERNS,
        grad_norm_rel_err=gnorm_rel, beta_rel_err_vs_plain_backend=err)


def run_main_path(args):
    cfg = get_config("logistic-paper")
    code = make_code(8, 4, 2, 2)
    lr = 1e-6
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    batch = make_synthetic_batch(rng, cfg, args.global_batch)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0

    def trainer(backend):
        return Trainer(cfg, code, optimizer=nag(lr),
                       spec=coding.SchemeSpec(backend=backend),
                       straggler_source=RandomStragglers(seed=1), seed=0)

    # ---- the first counted path: every launch count is 0 just before it
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = trainer("auto")
    if tr.arts.coded_fraction != 1.0:
        fail(f"coded_fraction {tr.arts.coded_fraction} != 1.0: beta is not coded")
    if tr.arts.codec.backend.name != "hopper":
        fail(f"backend {tr.arts.codec.backend.name!r} on the card, not the kernels")
    logs = [tr.step(batch) for _ in range(STEPS)]
    torch.cuda.synchronize()
    counts_train = ops.launch_counts()
    _note_paths("logistic-paper Trainer.step")
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in logs]
    if not all(np.isfinite(list(m.values())).all() for m in logs):
        fail(f"non-finite metrics: {logs}")
    # NAG's lambda sequence starts at 0, so its first step leaves the carried
    # point where it was: the loss moves from the second step on
    if not (losses[-1] < losses[0]
            and all(b < a for a, b in zip(losses[1:], losses[2:]))):
        fail(f"loss does not decrease: {losses}")
    want = _expect(coded_encode_2d=STEPS * code.n * code.d,
                   coded_decode_2d=STEPS)
    if counts_train != want:
        fail(f"kernel launches {counts_train}, the steps should issue {want}")
    beta = tr.params["beta"]
    if beta.shape != (343474,) or not torch.isfinite(beta).all() or \
            beta.device.type != "cuda":
        fail("beta after training: wrong shape, device or non-finite")
    steps_ms = [m["step_time_s"] * 1e3 for m in logs]
    say(phase="train", model=cfg.name, l=cfg.d_model, code=[8, 4, 2, 2],
        global_batch=args.global_batch, optimizer="nag", lr=lr,
        schedule="gather", packed=True, coded_fraction=tr.arts.coded_fraction,
        bucket_len=tr.arts.pack_plan.buckets[0].size, losses=losses,
        grad_norm=[m["grad_norm"] for m in logs], step_ms=steps_ms,
        step_ms_median_after_first=statistics.median(steps_ms[1:]),
        launches=counts_train, collectives=tr.arts.comm.counts,
        peak_memory_bytes=peak, batch_on_device_s=data_s)

    # ---- the second counted path, with counts of its own
    tr_p, counts_pipe, steady_ms, sync_sgd_ms = run_pipelined_path(
        args, cfg, code, batch)

    # ---- the third counted path, with counts of its own: a generic
    # parameter dict whose leaves keep trailing dims, synchronous (per leaf,
    # packed) and pipelined fused (fill + drain)
    params, loss_fn, mbatch = _mlp_case()
    placed = CodedBatcher(code).place(mbatch)
    grads = {}
    mopt = sgd_momentum(1e-3)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    for key, spec in (("leaf", coding.SchemeSpec(packed=False)),
                      ("packed", coding.SchemeSpec()),
                      ("pipelined", coding.SchemeSpec(pipelined=True,
                                                      fuse_apply=True)),
                      ("ref", coding.SchemeSpec(packed=False, backend="ref"))):
        if key == "ref":
            torch.cuda.synchronize()
            counts_mlp = ops.launch_counts()      # read just after the drive
            _note_paths("mlp make_coded_train_step")
        arts = make_coded_train_step(None, code, mopt,
                                     loss_fn=loss_fn, params_like=params,
                                     grad_scale=1.0, spec=spec)
        inp = arts.step_inputs((2, 5))
        if key == "pipelined":
            drv = PipelineDriver(arts)
            drv.step(params, mopt.init(params), placed, inp["W"], inp["mask"],
                     inp["rho"])
            pipe_p, pipe_s, _ = drv.drain(params, mopt.init(params))
            continue
        grads[key], _ = arts.aggregate(params, placed, inp["W"], inp["mask"],
                                       inp["rho"])
    torch.cuda.synchronize()
    # per leaf and packed alike, each worker encodes each of its d subset
    # gradients leaf by leaf: w1 and w2 through the 3D kernel, b through the
    # 2D one; per leaf every leaf is decoded alone, packed the one bucket is;
    # the pipelined fill folds the same encodes into the bucket
    # (coded_encode_acc) and the drain decodes and applies it in one launch
    per_drive = code.n * code.d
    want = _expect(coded_encode_2d=2 * per_drive, coded_encode_3d=4 * per_drive,
                   coded_decode_2d=1 + 1, coded_decode_3d=2,
                   coded_encode_acc_2d=per_drive,
                   coded_encode_acc_3d=2 * per_drive, coded_decode_apply=1)
    if counts_mlp != want:
        fail(f"generic step: kernel launches {counts_mlp}, the three drives "
             f"should issue {want}")
    if ops.launch_counts() != counts_mlp:
        fail("the plain backend launched a kernel")
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    direct = dict(zip(p, torch.autograd.grad(loss_fn(p, mbatch), list(p.values()))))
    mlp = {}
    for k in params:
        mlp[k] = {"vs_plain": _rel_err(grads["leaf"][k], grads["ref"][k]),
                  "vs_uncoded": _rel_err(grads["leaf"][k], direct[k]),
                  "packed_bitwise": bool(torch.equal(grads["leaf"][k],
                                                     grads["packed"][k]))}
        if mlp[k]["vs_plain"] > 1e-4 or mlp[k]["vs_uncoded"] > 1e-4:
            fail(f"generic step, leaf {k}: {mlp[k]}")
        if not mlp[k]["packed_bitwise"]:
            fail(f"generic step, leaf {k}: packed != per-leaf bitwise")
    # the synchronous update of the packed gradient (the optimizer alone:
    # no kernel) against the pipelined fused fill + drain, bit for bit
    sync_p, sync_s = mopt.update(grads["packed"], mopt.init(params), params)
    for k in params:
        mlp[k]["pipelined_fused_bitwise"] = bool(
            torch.equal(sync_p[k], pipe_p[k])
            and torch.equal(sync_s["mu"][k], pipe_s["mu"][k]))
        if not mlp[k]["pipelined_fused_bitwise"]:
            fail(f"generic step, leaf {k}: pipelined fused != sync bitwise")
    say(phase="train_generic", leaves={k: list(v.shape) for k, v in params.items()},
        stragglers=[2, 5], rel_err=mlp, seconds=time.perf_counter() - t0,
        launches=counts_mlp)

    # ---- checks outside the window
    ref = trainer("ref")
    ref_logs = [ref.step(batch) for _ in range(STEPS)]
    err = _rel_err(tr.params["beta"], ref.params["beta"])
    if not torch.allclose(tr.params["beta"], ref.params["beta"], rtol=1e-4,
                          atol=1e-4 * ref.params["beta"].abs().max().item()):
        fail(f"beta after {STEPS} steps: kernels vs plain backend differ "
             f"by {err:.3e} relative")
    inp = tr.arts.step_inputs((2, 5))
    placed = tr.batcher.place(batch)
    gen = torch.Generator().manual_seed(3)
    beta0 = (1e-3 * torch.randn(cfg.d_model, generator=gen)).to(DEV)
    g, _ = tr.arts.aggregate({"beta": beta0}, placed, inp["W"], inp["mask"],
                             inp["rho"])
    x, y = batch["x"], batch["y"].to(F32)
    uncoded = x.T @ (torch.sigmoid(x @ beta0) - y)
    gerr = _rel_err(g["beta"], uncoded)
    if gerr > 1e-4:
        fail(f"decoded gradient with stragglers (2, 5) differs from the "
             f"uncoded sum by {gerr:.3e} relative")
    say(phase="checks", beta_rel_err_vs_plain_backend=err,
        loss_plain_backend=[m["loss"] for m in ref_logs],
        plain_backend_step_ms=[m["step_time_s"] * 1e3 for m in ref_logs],
        decoded_grad_rel_err_2_stragglers=gerr)
    pipelined_checks(args, cfg, code, batch, tr_p)
    if args.profile:
        idle_sync = profile_steps(lambda: tr.step(batch),
                                  statistics.median(steps_ms[1:]),
                                  "synchronous NAG")
        tr_p.step(batch)                  # fill, then 3 steady steps
        torch.cuda.synchronize()
        idle_steady = profile_steps(lambda: tr_p.step(batch), steady_ms,
                                    "pipelined steady")
        tr_p.drain()
        say(phase="profile_idle", sync_nag=idle_sync, pipelined_steady=idle_steady,
            sync_sgd_step_ms=sync_sgd_ms, steady_step_ms=steady_ms)
    return {"logistic-paper Trainer.step": counts_train,
            "logistic-paper pipelined Trainer.step": counts_pipe,
            "mlp make_coded_train_step": counts_mlp}


# ------------------------------------------------------------- serve path
def _bitwise(a, b):
    """Equal bits (f32/int32 tensors of one shape, any devices)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def run_checkpoint_resume(args):
    """Checkpoint phase (a): a crash while the step-6 snapshot is written
    and a resume past it, on ``logistic-paper`` at full width.

    The uninterrupted run takes 6 steps with a snapshot every 2.  The
    step-6 file is then torn to a third of its size; a fresh ``Trainer`` on
    the same directory warns ``unreadable`` and resumes from step 4.  The
    data stream is replayed to its cursor by ``skip_to_cursor`` and the
    straggler stream by drawing the 4 patterns already inside the
    parameters (the trainer, like the reference's, keeps no straggler
    state), so its 2 steps (counted from 0) are the run's steps 5 and 6 and
    must give the same bits."""
    cfg = get_config("logistic-paper")
    code = make_code(8, 4, 2, 2)
    lr = 1e-6
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t_phase = time.perf_counter()

    def batches():
        rng = np.random.default_rng(SEED + 7)
        while True:
            yield {k: torch.from_numpy(v).to(DEV) for k, v in
                   make_synthetic_batch(rng, cfg, CKPT_BATCH).items()}

    def stragglers(skip):
        src = RandomStragglers(seed=1)
        for i in range(skip):
            src.draw(i, code)
        return src

    def trainer(skip):
        return Trainer(cfg, code, optimizer=nag(lr), seed=0, device=DEV,
                       straggler_source=stragglers(skip), checkpoint_dir=d,
                       checkpoint_every=CKPT_EVERY)

    try:
        tr = trainer(0)
        stream = batches()
        t0 = time.perf_counter()
        logs = [tr.step(next(stream)) for _ in range(CKPT_STEPS)]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        saved = tr._ckpt.steps()
        if saved != [2, 4, 6]:
            fail(f"checkpoint: snapshots at steps {saved}, not [2, 4, 6]")
        p6 = tr._ckpt.dir / "ckpt_00000006.npz"
        size = p6.stat().st_size
        p6.write_bytes(p6.read_bytes()[: size // 3])

        # ---- the counted path: the resumed trainer's construction and steps
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr2 = trainer(4)
        restore_s = time.perf_counter() - t0
        said = [str(w.message) for w in caught]
        if not any("unreadable" in m for m in said):
            fail(f"checkpoint: no 'unreadable' warning past the torn file: {said}")
        if (tr2._step_count, tr2._data_cursor) != (4, 4):
            fail(f"checkpoint: resumed at step {tr2._step_count}, cursor "
                 f"{tr2._data_cursor}, not 4 and 4")
        stream2 = tr2.skip_to_cursor(batches())
        logs2 = [tr2.step(next(stream2)) for _ in range(CKPT_STEPS - 4)]
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        _note_paths("logistic-paper Trainer resumed from a checkpoint")
        want = _expect(coded_encode_2d=2 * code.n * code.d, coded_decode_2d=2)
        if counts != want:
            fail(f"checkpoint: the resumed steps launched {counts}, not {want}")
        same = {"beta": _bitwise(tr.params["beta"], tr2.params["beta"]),
                "x_prev": _bitwise(tr.opt_state["x_prev"]["beta"],
                                   tr2.opt_state["x_prev"]["beta"]),
                "lam": _bitwise(tr.opt_state["lam"], tr2.opt_state["lam"]),
                "losses": [m["loss"] for m in logs[4:]] ==
                          [m["loss"] for m in logs2]}
        if not all(same.values()):
            fail(f"checkpoint: the resumed run differs from the uninterrupted "
                 f"one: {same}")
        resaved = tr2._ckpt.steps()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    say(phase="checkpoint", part="a", model=cfg.name, l=cfg.d_model,
        code=[8, 4, 2, 2], optimizer="nag", lr=lr, global_batch=CKPT_BATCH,
        steps=CKPT_STEPS, checkpoint_every=CKPT_EVERY, snapshots=saved,
        snapshot_bytes=size, torn_to_bytes=size // 3,
        warnings=[m[:120] for m in said], resumed_at_step=4,
        run_s=run_s, restore_s=restore_s, snapshots_after_resume=resaved,
        bitwise=same, launches=counts, losses=[m["loss"] for m in logs],
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return counts


def run_serve_path(args):
    """``CodedServer`` on qwen3-1.7b at full width with 4096-token prompts.

    Counted window: the launch counts and the plain flash version's call
    count are set to 0 just before the batches are submitted and read just
    after the last one is stepped.  Outside it: the uncoded forward of the
    first batch's prompts, the hedge, and the straggler-free serve."""
    cfg = get_config("qwen3-1.7b")
    code = make_code(*SERVE_CODE)
    k = code.num_subsets
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = model_api.init(cfg, DEV, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCHES * k, SERVE_SEQ),
                           dtype=np.int32)
    srv = CodedServer(cfg, code, params, batch_per_subset=1, seq_len=SERVE_SEQ,
                      straggler_source=RandomStragglers(seed=2), device=DEV)
    if srv.artifacts.codec.backend.name != "hopper":
        fail(f"serve backend {srv.artifacts.codec.backend.name!r}, not the kernels")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    flash_attn.PLAIN_CALLS["flash_attention"] = 0
    for row in prompts:
        srv.submit({"tokens": row})
    results, per_batch, step_ms = [], [], []
    before = ops.launch_counts()
    while True:
        t1 = time.perf_counter()
        res = srv.step()
        if res is None:
            break
        step_ms.append((time.perf_counter() - t1) * 1e3)
        now = ops.launch_counts()
        per_batch.append({kk: now[kk] - before[kk] for kk in now if now[kk] != before[kk]})
        before = now
        results.append(res)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    serve_paths = _note_paths("qwen3-1.7b CodedServer.step", require_vector=False)
    plain_calls = flash_attn.PLAIN_CALLS["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    if plain_calls:
        fail(f"the serving path called the plain flash version {plain_calls} times")
    per_prefill = cfg.n_layers
    want_batch = {"flash_attention": code.n * code.d * per_prefill,
                  "coded_encode_2d": code.n * code.d, "coded_decode_2d": 1}
    if len(results) != SERVE_BATCHES or any(pb != want_batch for pb in per_batch):
        fail(f"serving launches per batch {per_batch}, expected {want_batch} "
             f"in each of {SERVE_BATCHES} batches")
    for res in results:
        if res.outputs.shape != (k, cfg.vocab) or not np.isfinite(res.outputs).all():
            fail(f"served outputs: shape {res.outputs.shape} or non-finite")
        if res.failed_rows:
            fail(f"failed request rows {res.failed_rows} within the design s")
    ids = [r.req_id for res in results for r in res.requests]
    if ids != list(range(1, len(prompts) + 1)):
        fail(f"requests served out of order: {ids}")

    # ---- outside the window: the uncoded forward of batch 0's prompts
    first = {"tokens": torch.from_numpy(prompts[:k]).to(DEV)}
    t1 = time.perf_counter()
    with torch.no_grad():
        direct = model_api.make_forward(cfg)(params, first)
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t1) * 1e3
    direct = direct.cpu().numpy()
    scale = float(np.abs(direct).max())
    err = float(np.abs(results[0].outputs - direct).max())
    if err > SERVE_REL_TOL * max(1.0, scale):
        fail(f"decoded logits differ from the uncoded forward by {err:.3e} "
             f"(max |logit| {scale:.3e}, tolerance {SERVE_REL_TOL} of it)")
    # the hedge: under the pattern's W the straggler's payload never reaches
    # the output bits (its prompts replaced by others: the same bits)
    hedged = srv.serve_batch({"tokens": prompts[:k]}, stragglers=(1,))
    arts = srv.artifacts
    placed = CodedBatcher(code).place(first)
    other = torch.from_numpy(rng.integers(0, cfg.vocab, (code.d, 1, SERVE_SEQ),
                                          dtype=np.int32)).to(DEV)
    placed["tokens"][1] = other
    inp = arts.step_inputs((1,))
    with torch.no_grad():
        junk = arts.step(params, placed, inp["W"], inp["mask"], inp["rho"])
    junk = junk.cpu().numpy()
    if not np.array_equal(junk, hedged.outputs):
        fail("a straggler's payload changed the decoded bits")
    full = srv.serve_batch({"tokens": prompts[:k]}, stragglers=())
    diff_full = float(np.abs(full.outputs - hedged.outputs).max())
    if diff_full > SERVE_REL_TOL * max(1.0, scale):
        fail(f"stragglers (1,) and () decode {diff_full:.3e} apart")
    if args.profile:
        profile_steps(lambda: srv.serve_batch({"tokens": prompts[:k]}),
                      statistics.median(r.wall_s * 1e3 for r in results),
                      "coded serve batch", steps=1)
    say(phase="serve", model=cfg.name, params=n_params,
        param_bytes=sum(v.numel() * v.element_size() for v in params.values()),
        init_s=init_s, code=list(SERVE_CODE), batch_requests=k,
        seq_len=SERVE_SEQ, batches=len(results),
        stragglers=[list(r.stragglers) for r in results],
        wall_ms=[r.wall_s * 1e3 for r in results], step_ms=step_ms,
        launches_per_batch=per_batch, launches=counts,
        launches_by_kernel_path=serve_paths,
        plain_flash_calls=plain_calls, peak_memory_bytes=peak,
        uncoded_forward_ms=direct_ms, max_abs_logit=scale,
        max_abs_err_vs_uncoded=err, tolerance=SERVE_REL_TOL * max(1.0, scale),
        hedge_bitwise=True, stragglers_1_vs_none_max_abs_diff=diff_full,
        hedged_wall_ms=hedged.wall_s * 1e3, unhedged_wall_ms=full.wall_s * 1e3)
    return counts, len(results), params


# ------------------------------------------------------------ autotune paths
AT_CODE = (8, 4, 2, 2)         # (n, d, s, m) the autotuned trainer starts at
AT_STEPS = 16                  # steps of the autotuned logistic-paper run
AT_PIPE_STEPS = 3              # pipelined steps before and after the swap
AT_SERVE_CODE = (4, 3, 1, 2)   # the autotuned server's first scheme
AT_SERVE_BATCHES = 10          # batches the autotuned server serves
# the drift of the reference's trainer tests (tests/test_tune.py:406-407):
# communication-heavy (t2 = 16 s) before the switch, compute-heavy after
AT_DRIFT = (dict(lambda1=0.5, lambda2=0.2, t1=0.5, t2=16.0),
            dict(lambda1=0.5, lambda2=0.2, t1=16.0, t2=0.5))


def _drift(n, at, seed):
    """A timed straggler source at ``n`` workers whose constants switch from
    ``AT_DRIFT[0]`` to ``AT_DRIFT[1]`` at step ``at``."""
    from repro_torch.core.runtime_model import RuntimeParams
    from repro_torch.tune import DriftingSampler
    pa, pb = (RuntimeParams(n=n, **kw) for kw in AT_DRIFT)
    return DriftingSampler([(0, pa), (at, pb)], seed=seed)


def _plan_label(plan):
    return (f"{plan.family}({plan.d},{plan.s},{plan.m})"
            + (",pipelined" if plan.pipelined else ""))


def _launch_delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}


def _path_delta(p0, p1):
    out = {}
    for k in p1:
        d = {p: p1[k][p] - p0[k][p] for p in ("vector", "scalar")}
        if d["vector"] or d["scalar"]:
            out[k] = d
    return out


def _add_into(total, delta):
    for k, v in delta.items():
        if isinstance(v, dict):
            _add_into(total.setdefault(k, {}), v)
        else:
            total[k] = total.get(k, 0) + v


def _coded_launches(launches):
    return sum(v for k, v in launches.items() if k.startswith("coded_"))


def _record_scheme(schemes, label, launches, paths, **row):
    """Fold one step's (or batch's) launches and times into its scheme."""
    sc = schemes.setdefault(label, {"steps": 0, "launches": {},
                                    "launches_by_kernel_path": {}})
    sc["steps"] += 1
    _add_into(sc["launches"], launches)
    _add_into(sc["launches_by_kernel_path"], paths)
    for k, v in row.items():
        sc.setdefault(k, []).append(v)


def _coding_times(enc_shape, dec_shape):
    """The 2D encode and decode timed at one scheme's own shapes, on their
    vector path and, one element off an aligned base, on their scalar
    path (``dec_shape`` is ``(n, L, m)``)."""
    n, L, m = dec_shape
    row = {"m": m}
    for kname, kind, shape, mm in (("encode", "encode", enc_shape, None),
                                   ("decode", "decode", (n, L), m)):
        for path in ("vector", "scalar"):
            meas = measure(kind, shape, m=mm, scalar=path == "scalar")
            if meas["path"] != [path]:
                fail(f"{kname} {shape} took the {meas['path']} path, "
                     f"timed as {path}")
            row[kname] = {**row.get(kname, {}), "shape": meas["shape"],
                          "bound_ms": meas["bound_ms"],
                          "plain_ms": meas["plain_ms"],
                          f"{path}_ms": meas["ms"],
                          f"{path}_ms_per_launch_run":
                              meas["ms_per_launch_run"]}
    return row


def _forced_plan(family, d, s, m, n, **kw):
    from repro_torch.tune import Plan
    return Plan(family=family, d=d, s=s, m=m, k=kw.pop("k", n),
                loads=kw.pop("loads", (d,) * n), schedule="gather",
                packed=True, predicted_wait_s=0.0, predicted_step_s=0.0,
                predicted_total_s=0.0, **kw)


def run_autotune_train(args):
    """The autotuned ``Trainer`` on logistic-paper at full width.

    (a) counted window: launch counts set to 0 just before a synchronous
    NAG trainer with ``autotune=AutotunePolicy(...)`` (exact and FRC plans)
    under a drifting timed source takes 16 steps; each step's launches by
    kernel and kernel path go to the scheme it ran under.  Outside it: a
    twin on the plain backend replays the same swaps at the same steps
    (beta within rtol 1e-4), and a swap back to the first scheme builds no
    artifact.  (b) a pipelined fused trainer swaps while an update is in
    flight: the swap itself launches one ``coded_decode_apply`` (the drain
    under the outgoing code), and the run agrees with its plain twin.
    (c) one step under each of a forced rotation, block, hetero and
    expander plan.  Then the coding kernels are timed at every coded
    scheme's own shapes, on both kernel paths."""
    from repro_torch.core import plan_hetero
    from repro_torch.tune import AutotunePolicy
    cfg = get_config("logistic-paper")
    n = AT_CODE[0]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in
             make_synthetic_batch(rng, cfg, args.global_batch).items()}
    policy = AutotunePolicy(interval=3, window=6, min_samples=3,
                            schedules=("gather",), npts=4000,
                            approx_options=("frc",), max_err=3.0)
    lr = 1e-6

    def trainer(backend, autotune=None, pipelined=False):
        opt = sgd_momentum(PIPE_LR, 0.9) if pipelined else nag(lr)
        spec = coding.SchemeSpec(backend=backend, pipelined=pipelined,
                                 fuse_apply=pipelined or None)
        return Trainer(cfg, make_code(*AT_CODE), optimizer=opt, spec=spec,
                       straggler_source=_drift(n, 6, 3), autotune=autotune,
                       seed=0)

    # ---- (a) the counted path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = trainer("auto", policy)
    if tr.arts.codec.backend.name != "hopper":
        fail(f"autotune: backend {tr.arts.codec.backend.name!r}, not the kernels")
    first_plan = tr._current_plan()
    applied, replan_ms = [], []
    apply_plan, replan = tr._apply_plan, tr._tuner.maybe_replan

    def recording_apply(plan):
        applied.append((tr._step_count, plan))
        apply_plan(plan)

    def timed_replan(*a, **kw):
        events = len(tr._tuner.events)
        t0 = time.perf_counter()
        out = replan(*a, **kw)
        if len(tr._tuner.events) != events:
            replan_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tr._apply_plan, tr._tuner.maybe_replan = recording_apply, timed_replan
    schemes, logs = {}, []
    for _ in range(AT_STEPS):
        label = _plan_label(tr._current_plan())
        frac = tr.arts.coded_fraction
        c0, p0 = ops.launch_counts(), ops.path_counts()
        t0 = time.perf_counter()
        m = tr.step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        logs.append(m)
        _record_scheme(schemes, label, _launch_delta(c0, ops.launch_counts()),
                       _path_delta(p0, ops.path_counts()),
                       step_ms=m["step_time_s"] * 1e3, wall_ms=wall,
                       coded_fraction=frac)
    counts = ops.launch_counts()
    del tr._apply_plan, tr._tuner.maybe_replan      # the methods again
    label_a = "logistic-paper autotuned Trainer.step"
    paths = _note_paths(label_a, require_vector=False)
    peak = torch.cuda.max_memory_allocated()
    switched = [e for e in tr.autotune_events if e["switched"]]
    if not switched:
        fail(f"autotune_train: the tuner never switched: {tr.autotune_events}")
    if len(tr.telemetry) != AT_STEPS or tr.cached_schemes < 2:
        fail(f"autotune_train: {len(tr.telemetry)} records and "
             f"{tr.cached_schemes} cached schemes after {AT_STEPS} steps")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in logs):
        fail(f"autotune_train: non-finite metrics {logs}")
    if not _coded_launches(counts):
        fail("autotune_train: no coding kernel was launched")
    for label, sc in schemes.items():
        # l = 343474 = 2 * 171737: only m in (1, 2) groups beta; for any
        # other m the leaf rides the straggler-aware weighted sum uncoded
        coded = sc["coded_fraction"][0] == 1.0
        enc, dec = (sc["launches"].get("coded_encode_2d", 0),
                    sc["launches"].get("coded_decode_2d", 0))
        if coded and not (enc and dec):
            fail(f"autotune_train: scheme {label} codes beta but launched "
                 f"encode {enc} / decode {dec} times")
        if not coded and _coded_launches(sc["launches"]):
            fail(f"autotune_train: scheme {label} does not code beta but "
                 f"launched {sc['launches']}")
    # ---- outside the window: the plain-backend twin replays the swaps
    twin = trainer("ref")
    for t in range(AT_STEPS):
        twin.step(batch)
        for at, plan in applied:
            if at == t:
                twin._apply_plan(plan)
    torch.cuda.synchronize()
    b_k, b_p = tr.params["beta"], twin.params["beta"]
    atol = 1e-4 * b_p.abs().max().item()
    beta_err = _rel_err(b_k, b_p)
    if twin._scheme_sig != tr._scheme_sig or \
            not torch.allclose(b_k, b_p, rtol=1e-4, atol=atol):
        fail(f"autotune_train: beta against the plain twin {beta_err:.3e} "
             f"relative (schemes {tr._scheme_sig} / {twin._scheme_sig})")
    # a return to the first scheme (and a round trip more) builds nothing
    # once the first scheme has artifacts in the trainer's partial mode
    last_plan = tr._current_plan()
    cached0 = tr.cached_schemes
    tr._apply_plan(first_plan)
    cached1 = tr.cached_schemes
    tr._apply_plan(last_plan)
    tr._apply_plan(first_plan)
    if tr.cached_schemes != cached1 or (cached1 != cached0 and not tr.partial):
        fail(f"autotune_train: swaps back rebuilt artifacts ({cached0} -> "
             f"{cached1} -> {tr.cached_schemes})")
    run_a_s = time.perf_counter() - t_phase

    # ---- (b) a pipelined swap while an update is in flight
    plan_b = _forced_plan("uniform", 3, 1, 2, n, pipelined=True)
    pipe = {}
    for backend in ("auto", "ref"):
        tp = trainer(backend, pipelined=True)
        plog = [tp.step(batch) for _ in range(AT_PIPE_STEPS)]
        torch.cuda.synchronize()
        c0 = ops.launch_counts()
        if not tp._driver.in_flight:
            fail("autotune_train (b): nothing in flight before the swap")
        tp._apply_plan(plan_b)
        torch.cuda.synchronize()
        swap_launches = _launch_delta(c0, ops.launch_counts())
        plog += [tp.step(batch) for _ in range(AT_PIPE_STEPS)]
        plog.append(tp.drain())
        torch.cuda.synchronize()
        pipe[backend] = (tp, plog, swap_launches)
    tp, plog, swap_launches = pipe["auto"]
    if swap_launches != {"coded_decode_apply": 1}:
        fail(f"autotune_train (b): the swap launched {swap_launches}; the "
             f"drain under the outgoing code should launch one "
             f"coded_decode_apply")
    if pipe["ref"][2]:
        fail(f"autotune_train (b): the plain twin launched {pipe['ref'][2]}")
    fills = [i for i, m in enumerate(plog) if np.isnan(m["loss"])]
    if fills != [0, AT_PIPE_STEPS]:
        fail(f"autotune_train (b): fills at steps {fills}, expected 0 and "
             f"{AT_PIPE_STEPS}")
    pb_k, pb_p = tp.params["beta"], pipe["ref"][0].params["beta"]
    pipe_err = _rel_err(pb_k, pb_p)
    if not torch.allclose(pb_k, pb_p, rtol=1e-4,
                          atol=1e-4 * pb_p.abs().max().item()):
        fail(f"autotune_train (b): beta against the plain twin "
             f"{pipe_err:.3e} relative")

    # ---- (c) one step under each forced family
    hetero_loads = plan_hetero((1.0,) * n, s=1, m=2, k=2 * n).loads
    forced = [("rotation", _forced_plan("rotation", 3, 1, 2, n)),
              ("block", _forced_plan("block", 2, 1, 1, n, n0=2)),
              ("hetero", _forced_plan("hetero", max(hetero_loads), 1, 2, n,
                                      k=2 * n, loads=hetero_loads)),
              ("expander", _forced_plan("expander", 2, 1, 1, n))]
    tf = trainer("auto")
    families = {}
    for fam, plan in forced:
        tf._apply_plan(plan)
        c0, p0 = ops.launch_counts(), ops.path_counts()
        t0 = time.perf_counter()
        m = tf.step(batch)
        torch.cuda.synchronize()
        launches = _launch_delta(c0, ops.launch_counts())
        families[fam] = {"code": [tf.code.n, tf.code.d, tf.code.s, tf.code.m],
                         "k": tf.code.num_subsets, "partial": tf.partial,
                         "loss": m["loss"], "step_ms": m["step_time_s"] * 1e3,
                         "wall_ms": (time.perf_counter() - t0) * 1e3,
                         "launches": launches,
                         "launches_by_kernel_path": _path_delta(
                             p0, ops.path_counts())}
        if not np.isfinite(m["loss"]) or not _coded_launches(launches):
            fail(f"autotune_train (c): {fam}: {families[fam]}")

    # ---- the coding kernels at every coded scheme's own shapes
    shapes = set()
    for arts in list(tr._arts_cache.values()) + list(tf._arts_cache.values()):
        if arts.coded_fraction == 1.0 and arts.pack_plan is not None:
            mm = arts.codec.code.m
            shapes.add((mm, cfg.d_model // mm, arts.pack_plan.buckets[0].size))
    at_shapes = [_coding_times((1, V, mm), (n, L, mm))
                 for mm, V, L in sorted(shapes)]
    say(phase="autotune_train", model=cfg.name, l=cfg.d_model,
        start_code=list(AT_CODE), global_batch=args.global_batch,
        policy={"interval": 3, "window": 6, "min_samples": 3,
                "schedules": ["gather"], "npts": 4000,
                "approx_options": ["frc"], "max_err": 3.0},
        drift={"at_step": 6, "params": AT_DRIFT, "seed": 3},
        switches=[{"step": e["step"], "to": e["best"]} for e in switched],
        applied=[[at, _plan_label(pl)] for at, pl in applied],
        replan_host_ms=replan_ms, events=len(tr.autotune_events),
        schemes={k: {**v, "step_ms_median": statistics.median(v["step_ms"]),
                     "coded_fraction": v["coded_fraction"][0]}
                 for k, v in schemes.items()},
        losses=[m["loss"] for m in logs],
        modeled_wait_s=[m["modeled_wait_s"] for m in logs],
        cached_schemes=cached1, launches=counts, launches_by_kernel_path=paths,
        peak_memory_bytes=peak, beta_rel_err_vs_plain_twin=beta_err,
        pipelined_swap={"plan": _plan_label(plan_b),
                        "swap_launches": swap_launches,
                        "losses": [m["loss"] for m in plog],
                        "beta_rel_err_vs_plain_twin": pipe_err},
        forced_families=families, coding_kernels_at_scheme_shapes=at_shapes,
        seconds_counted_run_and_twin=run_a_s,
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return counts


def run_autotune_serve(args, params):
    """The autotuned ``CodedServer`` on qwen3-1.7b at full width (the serve
    phase's weights), 4096-token prompts, from code (4, 3, 1, 2) under a
    drifting timed source.

    Counted window: the launch counts are set to 0 just before the 10
    batches are submitted and read just after the last is stepped; each
    batch's launches go to the scheme it was served under.  Outside it:
    the first batch under every scheme against the uncoded forward of its
    prompts, one traced batch a scheme for its device idle share, and the
    coding kernels at each scheme's shapes on both kernel paths."""
    from repro_torch.tune import PoissonArrivals, ServingPolicy
    cfg = get_config("qwen3-1.7b")
    n = AT_SERVE_CODE[0]
    t_phase = time.perf_counter()
    policy = ServingPolicy(arrivals=PoissonArrivals(rate_rps=0.01),
                           interval=3, window=6, min_samples=3,
                           schedules=("gather",), wait_draws=200,
                           n_requests=800)
    srv = CodedServer(cfg, make_code(*AT_SERVE_CODE), params,
                      batch_per_subset=1, seq_len=SERVE_SEQ,
                      straggler_source=_drift(n, 4, 3), autotune=policy,
                      device=DEV)
    k = srv.batch_requests
    prompts = np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab, (AT_SERVE_BATCHES * k, SERVE_SEQ), dtype=np.int32)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    flash_attn.PLAIN_CALLS["flash_attention"] = 0
    for row in prompts:
        srv.submit({"tokens": row})
    schemes, firsts, results = {}, {}, []
    while True:
        code = srv.code
        label = f"uniform({code.d},{code.s},{code.m})"
        torch.cuda.reset_peak_memory_stats()
        c0, p0 = ops.launch_counts(), ops.path_counts()
        res = srv.step()
        if res is None:
            break
        torch.cuda.synchronize()
        launches = _launch_delta(c0, ops.launch_counts())
        want = code.n * code.d * cfg.n_layers
        if launches.get("flash_attention", 0) != want:
            fail(f"autotune_serve: batch {len(results)} under {label} "
                 f"launched flash {launches.get('flash_attention', 0)} "
                 f"times, expected {want}")
        if res.outputs.shape != (k, cfg.vocab) or \
                not np.isfinite(res.outputs).all() or res.failed_rows:
            fail(f"autotune_serve: batch {len(results)}: outputs "
                 f"{res.outputs.shape}, failed rows {res.failed_rows}")
        _record_scheme(schemes, label, launches,
                       _path_delta(p0, ops.path_counts()),
                       wall_ms=res.wall_s * 1e3,
                       peak_memory_bytes=torch.cuda.max_memory_allocated())
        firsts.setdefault(label, (len(results), res.outputs,
                                  [r.req_id - 1 for r in res.requests],
                                  (code.d, code.s, code.m)))
        results.append(res)
    counts = ops.launch_counts()
    label_s = "qwen3-1.7b autotuned CodedServer.step"
    paths = _note_paths(label_s, require_vector=False)
    plain_calls = flash_attn.PLAIN_CALLS["flash_attention"]
    switched = [e for e in srv._tuner.events if e["switched"]]
    # the serving tuner starts with no plan of its own, so its first adopted
    # plan counts as a switch even where it is the server's code: require a
    # change of code
    if len(results) != AT_SERVE_BATCHES or plain_calls or len(firsts) < 2:
        fail(f"autotune_serve: {len(results)} batches, {plain_calls} plain "
             f"flash calls, schemes served {list(firsts)}")
    ids = [r.req_id for res in results for r in res.requests]
    if ids != list(range(1, len(prompts) + 1)):
        fail(f"autotune_serve: requests served out of order: {ids}")
    # ---- outside the window: each scheme's first batch against the
    # uncoded forward of its prompts, then one traced batch a scheme
    fwd = model_api.make_forward(cfg)
    for label, (b, out, rows, dsm) in firsts.items():
        with torch.no_grad():
            direct = fwd(params, {"tokens": torch.from_numpy(
                prompts[rows]).to(DEV)}).cpu().numpy()
        scale = float(np.abs(direct).max())
        err = float(np.abs(out - direct).max())
        schemes[label].update(first_batch=b, max_abs_err_vs_uncoded=err,
                              max_abs_logit=scale)
        if err > SERVE_REL_TOL * max(1.0, scale):
            fail(f"autotune_serve: {label}, batch {b}: decoded logits "
                 f"{err:.3e} from the uncoded forward (max |logit| "
                 f"{scale:.3e}, tolerance {SERVE_REL_TOL} of it)")
    for label, (b, _, rows, (d, s_, mm)) in firsts.items():
        srv._apply_plan(dataclasses.replace(srv._tuner.current, d=d, s=s_,
                                            m=mm, loads=(d,) * n))
        batch_rows = {"tokens": prompts[rows]}
        schemes[label]["device_idle_share"] = profile_steps(
            lambda: srv.serve_batch(batch_rows, stragglers=()),
            statistics.median(schemes[label]["wall_ms"]),
            f"autotuned serve batch {label}", steps=1)
    at_shapes = {label: _coding_times(*_serve_codec_shapes((n,) + dsm))
                 for label, (_, _, _, dsm) in firsts.items()}
    say(phase="autotune_serve", model=cfg.name, start_code=list(AT_SERVE_CODE),
        seq_len=SERVE_SEQ, batches=len(results),
        policy={"rate_rps": 0.01, "interval": 3, "window": 6,
                "min_samples": 3, "schedules": ["gather"], "wait_draws": 200,
                "n_requests": 800},
        drift={"at_batch": 4, "params": AT_DRIFT, "seed": 3},
        switches=[{"batch": e["step"], "to": e["best"]} for e in switched],
        stragglers=[list(r.stragglers) for r in results],
        schemes={k: {**v, "wall_ms_median": statistics.median(v["wall_ms"]),
                     "flash_launches_per_batch":
                         v["launches"].get("flash_attention", 0) / v["steps"]}
                 for k, v in schemes.items()},
        launches=counts, launches_by_kernel_path=paths,
        plain_flash_calls=plain_calls, coding_kernels_at_scheme_shapes=at_shapes,
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return counts


class materialized_attention:
    """Within it, the dense LM's attention is the materialized f32 softmax
    at every length (the reference's branch up to 2048 tokens), never the
    flash kernel."""

    def __enter__(self):
        self.old = model_common.CHUNK_THRESHOLD
        model_common.CHUNK_THRESHOLD = 1 << 40

    def __exit__(self, *exc):
        model_common.CHUNK_THRESHOLD = self.old


def run_generate_path(args, params):
    """``BatchedEngine.generate`` on qwen3-1.7b at full width and depth
    (the serve phase's seeded weights, f32): 4 prompts of 4096 tokens, 32
    greedy tokens against a dense cache of 4128 positions.

    Counted window: the launch counts are set to 0 just before
    ``generate`` and read at its prefill's logits and after it.  Outside
    it: decode steps 0, 1 and 31 against the full-prompt forward of the
    prompt and the tokens fed so far, with the materialized softmax (the
    decode's own attention math); the distance to the forward through the
    flash kernel is printed beside it."""
    cfg = get_config("qwen3-1.7b")
    t_phase = time.perf_counter()
    seq_len = GEN_PROMPT + GEN_NEW
    prompts = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT), dtype=np.int32)
    eng = BatchedEngine(cfg, params, batch=GEN_BATCH, seq_len=seq_len,
                        device=DEV)
    events, flash_at, kept = {}, {}, {}

    def on_logits(t, logits):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[t] = ev
        flash_at[t] = ops.launch_counts()["flash_attention"]
        if t in GEN_CHECKED:
            kept[t] = logits

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    flash_attn.PLAIN_CALLS["flash_attention"] = 0
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, GEN_NEW, on_logits=on_logits)
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plain = flash_attn.PLAIN_CALLS["flash_attention"]
    prefill_flash = flash_at[-1]
    decode_flash = counts["flash_attention"] - prefill_flash
    if plain or prefill_flash != cfg.n_layers or decode_flash:
        fail(f"generate: flash launches {prefill_flash} in the prefill and "
             f"{decode_flash} in the decode, plain calls {plain}; expected "
             f"{cfg.n_layers}, 0 and 0")
    want = _expect(flash_attention=cfg.n_layers)
    if counts != want:
        fail(f"generate: kernel launches {counts}, expected {want}")
    if tokens.shape != (GEN_BATCH, GEN_NEW) or tokens.dtype != np.int32 or \
            not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        fail(f"generate: tokens of shape {tokens.shape}, type {tokens.dtype} "
             f"or out of [0, {cfg.vocab})")
    prefill_ms = start.elapsed_time(events[-1])
    step_ms = [events[t - 1].elapsed_time(events[t]) for t in range(GEN_NEW)]
    median_ms = statistics.median(step_ms[2:])

    # ---- outside the window: decode logits against the full forward
    errs = {}
    t1 = time.perf_counter()
    toks = torch.from_numpy(np.concatenate([prompts, tokens], axis=1)).to(DEV)
    forward = model_api.make_forward(cfg)
    for t in GEN_CHECKED:
        batch = {"tokens": toks[:, :GEN_PROMPT + t + 1]}
        with torch.no_grad(), materialized_attention():
            want_l = forward(eng.params, batch)
        with torch.no_grad():
            flash_l = forward(eng.params, batch)
        err = (kept[t] - want_l).abs()
        excess = (err - GEN_TOL * want_l.abs()).max().item()
        errs[str(t)] = {
            "max_abs_err": err.max().item(),
            "max_abs_logit": want_l.abs().max().item(),
            "max_abs_err_vs_flash_forward": (kept[t] - flash_l).abs().max().item(),
            "flash_forward_vs_materialized": (flash_l - want_l).abs().max().item()}
        del want_l, flash_l
        if not excess <= GEN_TOL:
            fail(f"generate: decode step {t}'s logits differ from the "
                 f"full-prompt forward past rtol = atol = {GEN_TOL}: "
                 f"{errs[str(t)]}")
        # the greedy token fed next is the decode's own argmax
        if t + 1 < GEN_NEW and not torch.equal(
                kept[t].argmax(-1).cpu(),
                torch.from_numpy(tokens[:, t + 1]).long()):
            fail(f"generate: token {t + 1} is not step {t}'s argmax")
    check_s = time.perf_counter() - t1
    weight_bytes = sum(v.numel() * v.element_size() for k, v in params.items()
                       if k != "embed")
    cache_bytes = sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
                      for shape, dt in eng.arts.cache_shapes.values())
    bound_ms = (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    if args.profile:
        with torch.no_grad():
            _, cache = eng.arts.prefill(eng.params,
                                        {"tokens": toks[:, :GEN_PROMPT]})
        tok = toks[:, GEN_PROMPT].to(torch.int32)

        def one_step():
            nonlocal cache
            _, cache = eng.arts.decode(eng.params, cache, tok)

        one_step()                     # warm; 3 traced steps after it
        profile_steps(one_step, median_ms, "qwen3-1.7b BatchedEngine decode step",
                      steps=3)
        del cache
    say(phase="generate", model=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
        max_new=GEN_NEW, seq_len=seq_len, window=0, dtype="float32",
        weights="the serve phase's, random from a seed",
        flash_launches_prefill=prefill_flash, flash_launches_decode=decode_flash,
        launches=counts, plain_flash_calls=plain,
        generate_wall_s=wall_s, prefill_s=prefill_ms / 1e3,
        decode_step_ms=step_ms, decode_step_ms_median_2_to_31=median_ms,
        tokens_per_s=GEN_BATCH * 1e3 / median_ms,
        decode_bytes_weights=weight_bytes, decode_bytes_kv_cache=cache_bytes,
        decode_step_bound_ms=bound_ms, decode_step_bound_by="bytes",
        decode_step_over_bound=median_ms / bound_ms,
        peak_memory_bytes=peak, logits_vs_forward=errs, tolerance=GEN_TOL,
        check_s=check_s, tokens_first_row=tokens[0].tolist(),
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())
    return counts


# ----------------------------------------------------- LM training path
def _digest(tensors):
    """Exact fingerprint of f32 tensors' bits: per tensor, the sum of its
    words and their sum weighted by position (mod 8191), in int64 (equal
    bits give equal digests; other bits almost surely do not)."""
    out = []
    for t in tensors:
        words = t.detach().reshape(-1).view(torch.int32)
        plain = weighted = 0
        for lo in range(0, words.numel(), 1 << 24):
            w = words[lo:lo + (1 << 24)].to(torch.int64)
            pos = torch.arange(lo, lo + w.numel(), device=w.device) % 8191 + 1
            plain += int(w.sum())
            weighted += int((w * pos).sum())
        out.append((plain, weighted))
    return out


def _lm_expected(tr, steps, pipelined):
    """Launch counts ``steps`` calls of a Trainer on the LM issue: flash
    forward twice a layer and subset (the checkpoint recomputes it), its
    backward once, one encode a coded leaf and subset (2D for a 1-D leaf,
    3D for the others), one 2D decode (or fused decode-apply) a bucket and
    retired update."""
    cfg, code = tr.cfg, tr.code
    subsets = code.n * code.d
    coded = [k for k, pl in tr.arts.plans.items() if pl.coded]
    one_d = sum(1 for k in coded if tr.params[k].ndim == 1)
    buckets = len(tr.arts.pack_plan.buckets)
    enc = "coded_encode_acc" if pipelined else "coded_encode"
    want = {"flash_attention": 2 * cfg.n_layers * subsets * steps,
            "flash_attention_bwd": cfg.n_layers * subsets * steps,
            f"{enc}_2d": one_d * subsets * steps,
            f"{enc}_3d": (len(coded) - one_d) * subsets * steps,
            ("coded_decode_apply" if pipelined else "coded_decode_2d"):
                buckets * steps}
    return _expect(**{k: v for k, v in want.items() if v})


def _lm_scalar_leaves(tr):
    """Coded leaves whose 3D encode operand would leave the 16-byte vector
    path by its shape: R (the trailing elements after the grouping dim) not
    a whole number of f32 vectors."""
    out = []
    for k, pl in tr.arts.plans.items():
        if pl.coded and tr.params[k].ndim > 1:
            shape = list(tr.params[k].shape)
            del shape[pl.group_dim]
            if math.prod(shape) % 4:
                out.append(k)
    return out


def _lm_batches(cfg, code):
    rng = np.random.default_rng(SEED)
    return [{k: torch.from_numpy(v).to(DEV) for k, v in
             make_synthetic_batch(rng, cfg, code.num_subsets, LM_SEQ).items()}
            for _ in range(LM_STEPS)]


def _lm_run(tr, batches, label, drain=False):
    """The Trainer's steps over ``batches`` (and a drain), counted from 0;
    returns the logs, counts, paths and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    flash_attn.PLAIN_CALLS["flash_attention"] = 0
    logs = [_timed_steps(tr, b, 1)[0] for b in batches]
    if drain:
        t0 = time.perf_counter()
        m = tr.drain()
        torch.cuda.synchronize()
        m["wall_ms"] = (time.perf_counter() - t0) * 1e3
        logs.append(m)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    paths = _note_paths(label, require_vector=False)
    plain = flash_attn.PLAIN_CALLS["flash_attention"]
    if plain:
        fail(f"{label}: the plain flash version ran {plain} times")
    return logs, counts, paths, torch.cuda.max_memory_allocated()


def _lm_check_run(label, tr, logs, counts, want):
    if tr.arts.codec.backend.name != "hopper":
        fail(f"{label}: backend {tr.arts.codec.backend.name!r}, not the kernels")
    if tr.arts.coded_fraction != 1.0:
        fail(f"{label}: coded fraction {tr.arts.coded_fraction}")
    for m in logs[-LM_STEPS:]:          # a pipeline's fill retires nothing
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            fail(f"{label}: non-finite metrics {logs}")
    if counts != want:
        fail(f"{label}: kernel launches {counts}, the code implies {want}")
    bad = [k for k, v in tr.params.items() if not torch.isfinite(v).all()]
    if bad:
        fail(f"{label}: non-finite parameters {bad[:4]}")


def _lm_grad_check(tr, batch):
    """The decoded gradient with one straggler against the uncoded gradient
    of the same batch: the mean over its sequences of each one's gradient,
    one sequence at a time.  Returns the relative error norm."""
    arts, code, cfg = tr.arts, tr.code, tr.cfg
    placed = CodedBatcher(code).place(batch)
    inp = arts.step_inputs((1,))
    dec, _ = arts.aggregate(tr.params, placed, inp["W"], inp["mask"], inp["rho"])
    del placed
    loss_fn = model_api.make_loss(cfg)
    names = list(tr.params)
    p = {k: v.detach().requires_grad_(True) for k, v in tr.params.items()}
    k_sub = code.num_subsets
    num = den = 0.0
    unc = None
    for j in range(k_sub):
        sub = {key: v[j:j + 1] for key, v in batch.items()}
        g = torch.autograd.grad(loss_fn(p, sub), [p[n] for n in names])
        if unc is None:
            unc = [x / k_sub for x in g]
        else:
            for u, x in zip(unc, g):
                u.add_(x / k_sub)
        del g
    for name, u in zip(names, unc):
        num += float(torch.sum((dec[name] - u) ** 2))
        den += float(torch.sum(u * u))
    rel = math.sqrt(num / den)
    if not rel <= LM_GRAD_REL_TOL:
        fail(f"the decoded LM gradient with a straggler is {rel:.3e} from the "
             f"uncoded one (relative norm), past {LM_GRAD_REL_TOL}")
    return rel


def _lm_fill_drain_check(tr, batch):
    """Fill + drain against the synchronous step (the same SGD-momentum, the
    pipelined Trainer's own artifacts) from the Trainer's state, bit for
    bit: params, momentum and loss, compared through exact digests so that
    the two results never share the card."""
    arts = tr.arts
    placed = CodedBatcher(tr.code).place(batch)
    inp = arts.step_inputs((2,))
    a = (inp["W"], inp["mask"], inp["rho"])
    names = list(tr.params)
    ps, ss, ms = arts.step(tr.params, tr.opt_state, placed, *a)
    want = _digest([ps[k] for k in names] + [ss["mu"][k] for k in names])
    want_loss = float(ms["loss"])
    del ps, ss, ms
    drv = PipelineDriver(arts)
    pp, sp, mp = drv.step(tr.params, tr.opt_state, placed, *a)
    if mp is not None:
        fail("the LM pipeline's fill retired an update")
    pp, sp, mp = drv.drain(pp, sp)
    got = _digest([pp[k] for k in names] + [sp["mu"][k] for k in names])
    if got != want or float(mp["loss"]) != want_loss:
        fail("LM fill + drain differs from the synchronous step")
    return True


def checkpoint_lm(tr):
    """Checkpoint phase (b): the synchronous LM trainer's parameters and
    NAG state saved with ``maybe_checkpoint(force=True)`` and restored onto
    the host into a tree of the same structure (``like`` leaves of
    ``torch.empty`` on the CPU), then compared leaf by leaf, bitwise, one
    leaf on the host at a time: no second copy on the card."""
    t_phase = time.perf_counter()
    d = tr._ckpt.dir
    state = [*tr.params.values(), *tr.opt_state["x_prev"].values(),
             tr.opt_state["lam"]]
    nbytes = sum(v.numel() * v.element_size() for v in state)
    free = shutil.disk_usage(d).free
    if free < nbytes * 1.01:
        fail(f"checkpoint: {d} has {free} bytes free, the snapshot needs "
             f"{nbytes}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.maybe_checkpoint(force=True)
    save_s = time.perf_counter() - t0
    path = tr._ckpt._step_path(tr._step_count)
    file_bytes = path.stat().st_size

    def host(t):
        return torch.empty(t.shape, dtype=t.dtype, device="cpu")

    like = {"params": convert.unflatten({k: host(v) for k, v in tr.params.items()}),
            "opt_state": {"x_prev": convert.unflatten(
                {k: host(v) for k, v in tr.opt_state["x_prev"].items()}),
                "lam": host(tr.opt_state["lam"])}}
    t0 = time.perf_counter()
    got, meta = tr._ckpt.restore_latest(like)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = convert.flatten(got["params"])
    x_prev = convert.flatten(got["opt_state"]["x_prev"])
    bad = [k for k, v in tr.params.items() if not _bitwise(v, params[k])]
    bad += [f"x_prev/{k}" for k, v in tr.opt_state["x_prev"].items()
            if not _bitwise(v, x_prev[k])]
    if not _bitwise(tr.opt_state["lam"], got["opt_state"]["lam"]):
        bad.append("lam")
    compare_s = time.perf_counter() - t0
    if bad or meta.get("step") != tr._step_count:
        fail(f"checkpoint: the restored LM state differs at {bad[:4]} "
             f"(step {meta.get('step')})")
    del got, params, x_prev, like
    say(phase="checkpoint", part="b", model=tr.cfg.name,
        n_layers=tr.cfg.n_layers, step=tr._step_count,
        leaves=len(state), state_bytes=nbytes, file_bytes=file_bytes,
        free_bytes_before=free, save_s=save_s,
        save_gb_per_s=nbytes / save_s / 1e9, restore_s=restore_s,
        restore_gb_per_s=nbytes / restore_s / 1e9, compare_s=compare_s,
        bitwise=True, metadata={k: meta[k] for k in ("arch", "data_cursor",
                                                     "seed", "step")},
        seconds=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi_line())


def run_train_lm_path(args):
    """Coded training of qwen3-1.7b at full width on 4096-token sequences.

    Synchronous: ``Trainer`` with NAG over all 28 layers, code (4, 3, 1, 2),
    random stragglers, one sequence a subset, 3 steps, counted from 0; then,
    outside the window, the decoded gradient with a straggler against the
    uncoded one.  Pipelined: ``SchemeSpec(pipelined=True, fuse_apply=True)``
    with SGD-momentum, also over 28 layers, 3 steps and a drain, counted
    from 0; then fill + drain against the synchronous step, bitwise.
    Weights are random from a seeded CUDA generator (the Trainer's)."""
    full = get_config("qwen3-1.7b")
    code = make_code(*LM_CODE)
    batches = _lm_batches(full, code)
    res = {}
    for label, cfg, opt, spec in (
            ("qwen3-1.7b Trainer.step", full, nag(LM_NAG_LR), None),
            # the pipelined step's peak is about 8.4 P + 11 GB (P the
            # parameters' bytes: old and new params and momentum, two
            # wires, one subset's gradients; the activations): 79 GB of the
            # card's 85 at full depth
            ("qwen3-1.7b pipelined Trainer.step", full,
             sgd_momentum(LM_SGD_LR, 0.9),
             coding.SchemeSpec(pipelined=True, fuse_apply=True))):
        pipelined = spec is not None
        gc.collect()           # the last path's trainer, and any cycles
        torch.cuda.empty_cache()
        at_start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ckpt_dir = None if pipelined else tempfile.mkdtemp(
            prefix="chip_smoke_lm_ckpt_")
        tr = Trainer(cfg, code, opt, spec=spec, seed=SEED, device=DEV,
                     straggler_source=RandomStragglers(seed=3),
                     checkpoint_dir=ckpt_dir)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        logs, counts, paths, peak = _lm_run(tr, batches, label,
                                            drain=pipelined)
        want = _lm_expected(tr, LM_STEPS, pipelined)
        _lm_check_run(label, tr, logs, counts, want)
        steps_ms = [m["wall_ms"] for m in logs[:LM_STEPS]]
        t0 = time.perf_counter()
        if pipelined:
            check = {"fill_drain_equals_sync_bitwise":
                     _lm_fill_drain_check(tr, batches[0])}
        else:
            check = {"decoded_vs_uncoded_grad_rel_norm":
                     _lm_grad_check(tr, batches[0]),
                     "tolerance": LM_GRAD_REL_TOL}
        torch.cuda.synchronize()
        check["seconds"] = time.perf_counter() - t0
        check["check_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        if args.profile and not pipelined:
            profile_steps(lambda: tr.step(batches[0]),
                          statistics.median(steps_ms[1:]), label, steps=1)
        n_params = sum(v.numel() for v in tr.params.values())
        say(phase="train_lm", path=label, model=cfg.name,
            n_layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
            seq_len=LM_SEQ, code=list(LM_CODE),
            global_batch=code.num_subsets, steps=LM_STEPS,
            optimizer="sgd_momentum" if pipelined else "nag",
            lr=LM_SGD_LR if pipelined else LM_NAG_LR,
            schedule="gather", packed=True, wire="float32",
            pipelined=pipelined, fuse_apply=pipelined,
            reduced={"global_batch": f"{code.num_subsets} sequences, not "
                                     f"train_4k's 256",
                     "steps": LM_STEPS, "weights": "random, seeded"},
            build_s=build_s,
            losses=[m["loss"] for m in logs],
            grad_norm=[m["grad_norm"] for m in logs],
            step_ms=[m["wall_ms"] for m in logs],
            step_ms_median_after_first=statistics.median(steps_ms[1:]),
            launches=counts, launches_expected=want,
            launches_per_step={k: v / LM_STEPS for k, v in counts.items() if v},
            launches_by_kernel_path=paths,
            scalar_path_leaves_by_shape=_lm_scalar_leaves(tr),
            plain_flash_calls=0, memory_at_start_bytes=at_start,
            peak_memory_bytes=peak,
            memory_limit_bytes=torch.cuda.get_device_properties(0).total_memory,
            **check)
        res[label] = counts
        if ckpt_dir is not None:
            try:
                checkpoint_lm(tr)
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
        del tr, logs
    return res


# --------------------------------------------------------------------- main
def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--global-batch", type=int, default=512,
                    help="samples per step (divisible by 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 3 train steps with torch.profiler")
    ap.add_argument("--out", default=None,
                    help="also write the kernel report to this JSON file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    say(phase="env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        nvidia_smi=smi, matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    lib = _build.load()
    flash_ptxas = flash_kernels_ptxas(_build.ptxas_report())
    flash_smem = {f"{t}_hd{hd}": lib.flash_attention_smem_bytes(code, hd)
                  for t, code in (("f32", 0), ("bf16", 1)) for hd in (32, 64, 128)}
    bwd_smem = {f"{t}_hd{hd}": lib.flash_attention_bwd_smem_bytes(code, hd)
                for t, code in (("f32", 0), ("bf16", 1)) for hd in (32, 64, 128)}
    say(phase="build", **_build.last_build,
        sources=[str(p.relative_to(HERE)) for p in _build.sources()],
        flash_kernel_ptxas=flash_ptxas, flash_kernel_smem_bytes=flash_smem,
        flash_bwd_smem_bytes=bwd_smem)
    spilled = {k: v for k, v in flash_ptxas.items()
               if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    if spilled:
        fail(f"flash kernels spill registers: {spilled}")

    errs = check_kernels()
    errs["flash_attention_bwd"] = check_flash_bwd(torch.Generator().manual_seed(5))
    main_shapes = {
        "coded_encode_2d": measure("encode", (1, 171737, 2)),
        "coded_encode_3d": measure("encode", (1, 3072, 2, 2048)),
        "coded_decode_2d": measure("decode", (8, 171776), m=2),
        "coded_decode_3d": measure("decode", (8, 3072, 2048), m=2),
        "coded_encode_acc_2d": measure("encode_acc", (1, 171737, 2)),
        "coded_encode_acc_3d": measure("encode_acc", (1, 3072, 2, 2048)),
        "coded_decode_apply": measure("decode_apply", (8, 171776), m=2),
        "flash_attention": measure("flash", (1, SERVE_SEQ, 16, 8, 128)),
        "flash_attention_bwd": measure("flash_bwd", (1, LM_SEQ, 16, 8, 128)),
    }
    other_shapes = {
        "flash_attention": [measure("flash", (1, SERVE_SEQ, 16, 8, 128),
                                    dtype=torch.bfloat16,
                                    out_dtype=torch.bfloat16)],
        "flash_attention_bwd": [measure("flash_bwd", (1, LM_SEQ, 16, 8, 128),
                                        dtype=torch.bfloat16,
                                        out_dtype=torch.bfloat16)],
        "coded_encode_2d": [measure("encode", (4, 4194304, 2)),
                            measure("encode", (1, 171737, 2), dtype=torch.bfloat16,
                                    out_dtype=torch.bfloat16)],
        "coded_encode_3d": [measure("encode", (4, 3072, 2, 2048))],
        "coded_decode_2d": [measure("decode", (8, 4194304), m=2),
                            measure("decode", (8, 4194304), m=2,
                                    dtype=torch.bfloat16)],
        "coded_decode_3d": [measure("decode", (8, 3072, 2048), m=2,
                                    dtype=torch.bfloat16)],
    }
    floor = measure_launch_floor()
    say(phase="kernels_check", tolerance={"f32": 2e-5, "bf16": 2e-2},
        errors=errs, launch_floor=floor, at_main_path_shapes=main_shapes,
        at_other_shapes=other_shapes)
    check_packed_per_leaf_small()

    counts = run_main_path(args)
    counts["logistic-paper autotuned Trainer.step"] = run_autotune_train(args)
    serve_path = "qwen3-1.7b CodedServer.step"
    counts[serve_path], n_batches, params = run_serve_path(args)
    counts["qwen3-1.7b autotuned CodedServer.step"] = \
        run_autotune_serve(args, params)
    gen_path = "qwen3-1.7b BatchedEngine.generate"
    counts[gen_path] = run_generate_path(args, params)
    del params
    counts["logistic-paper Trainer resumed from a checkpoint"] = \
        run_checkpoint_resume(args)
    counts.update(run_train_lm_path(args))
    lm_path = "qwen3-1.7b Trainer.step"
    # each kernel's launches are those of the path that runs it: the 2D pair
    # on logistic-paper (one flat leaf), the fused 2D pair on its pipelined
    # run, the 3D variants on the MLP's matrices, flash attention on the
    # serving path (which also runs the 2D pair, counted there too)
    trainer_path, pipe_path, mlp_path = list(counts)[:3]
    path_of = {"coded_encode_2d": trainer_path, "coded_decode_2d": trainer_path,
               "coded_encode_3d": mlp_path, "coded_decode_3d": mlp_path,
               "coded_encode_acc_2d": pipe_path, "coded_decode_apply": pipe_path,
               "coded_encode_acc_3d": mlp_path, "flash_attention": serve_path,
               "flash_attention_bwd": lm_path}

    replaces = {"coded_encode_2d": "src/repro/kernels/coded_encode.py:76",
                "coded_encode_3d": "src/repro/kernels/coded_encode.py:93",
                "coded_decode_2d": "src/repro/kernels/coded_decode.py:59",
                "coded_decode_3d": "src/repro/kernels/coded_decode.py:73",
                "coded_encode_acc_2d": "src/repro/kernels/coded_encode.py:143",
                "coded_encode_acc_3d": "src/repro/kernels/coded_encode.py:159",
                "coded_decode_apply": "src/repro/kernels/coded_decode.py:134",
                "flash_attention": "src/repro/kernels/flash_attn.py:99",
                # no TPU kernel: the reference differentiates its
                # online_attention with XLA's autodiff
                "flash_attention_bwd": "src/repro/models/common.py:154"}
    kernels = []
    for name, meas in main_shapes.items():
        stem = ("flash_attn_bwd" if name == "flash_attention_bwd" else
                "flash_attn" if name == "flash_attention" else
                "coded_encode" if name.startswith("coded_encode") else
                "coded_decode")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{stem}.cu",
            "replaces": replaces[name], "path": path_of[name],
            "launches": counts[path_of[name]][name],
            "max_abs_err": errs[name]["max_abs_err"],
            "ms": meas["ms"], "plain_ms": meas["plain_ms"],
            "bound_ms": meas["bound_ms"], "bound_by": meas["bound_by"],
            "library_ms": meas["library_ms"], "shape": meas["shape"],
            "dtype": meas["dtype"], "ms_l2_warm": meas["ms_l2_warm"]})
        if name == "flash_attention":
            kernels[-1]["launches_per_batch"] = kernels[-1]["launches"] / n_batches
            kernels[-1]["launches_generate_prefill"] = \
                counts[gen_path]["flash_attention"]
        if name == "flash_attention_bwd":
            kernels[-1]["launches_per_step"] = kernels[-1]["launches"] / LM_STEPS
            kernels[-1]["max_rel_norm_err"] = errs[name]["max_rel_norm_err"]
        if name.startswith("flash"):
            kernels[-1]["bound_ms_f32_cuda_cores"] = meas["bound_ms_f32_cuda_cores"]
        else:
            kernels[-1].update(
                ms_per_launch_run=meas["ms_per_launch_run"],
                launch_floor_ms=floor["ms"],
                launch_floor_ms_per_launch_run=floor["ms_per_launch_run"],
                host_us_per_call=meas["host_us_per_call"])
        if name in ops.path_counts():
            kernels[-1].update(
                path_at_timed_shape=meas["path"],
                launches_by_kernel_path=KERNEL_PATHS[path_of[name]][name])
        if name.startswith("flash"):
            bf16 = other_shapes[name][0]
            kernels[-1]["bf16"] = {k: bf16[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        if kernels[-1]["launches"] == 0:
            fail(f"kernel {name} was not launched on its path, {path_of[name]}")
    report = {"kernels": kernels, "launches_by_path": counts,
              "launches_by_kernel_path": KERNEL_PATHS}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {**report, "nvidia_smi": smi, "errors": errs,
             "at_other_shapes": other_shapes}, indent=1))
    say(phase="done", seconds=time.perf_counter() - t_start)
    say(**report)
    print(nvidia_smi_line(), flush=True)
    say(ok=True, device={"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
