#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--global-batch 512] [--profile] [--out report.json]

Drives ``repro_torch`` only (nothing of the JAX package), on the card only:

  env      versions, and the card's name and power limit from nvidia-smi
  build    compiles ``src/repro_torch/kernels/csrc/*.cu`` with nvcc into
           ``build/`` and loads the library
  kernels  holds each CUDA kernel (coded_encode / coded_decode, 2D and 3D)
           against its plain PyTorch version and against ``torch.einsum``
           over ragged sweeps in f32 and bf16, and times it at the main
           path's shapes, on inputs that are not in the L2 cache, beside its
           plain version, ``torch.einsum`` and its byte bound
  train    the main path: ``Trainer`` on ``logistic-paper`` at full width
           (l = 343474), code (n, d, s, m) = (8, 4, 2, 2), NAG, random
           stragglers, 5 steps; then a two-layer MLP as a plain parameter
           dict through ``make_coded_train_step`` (trailing dims -> the 3D
           kernel variants).  Each of the two paths has its own counts:
           the kernel launch counts are set to 0 just before it and read
           just after it.
  checks   the same 5 steps on the plain backend on the card, the decoded
           gradient with 2 stragglers against the uncoded gradient, packed
           against per-leaf bitwise

Each phase prints one JSON line.  Any failed phase ends the run with a
non-zero exit code; without a CUDA device the script exits with code 2 and
prints no result.  The last line of standard output is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

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

    from repro_torch import coding
    from repro_torch.configs import get_config
    from repro_torch.core import make_code
    from repro_torch.data import CodedBatcher, make_synthetic_batch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.coded_decode import (coded_decode,
                                                  coded_decode_plain)
    from repro_torch.kernels.coded_encode import (coded_encode,
                                                  coded_encode_plain)
    from repro_torch.optim import nag, sgd_momentum
    from repro_torch.train import Trainer, make_coded_train_step
    from repro_torch.tune import RandomStragglers
except ImportError as e:
    print(f"chip_smoke: the port's package does not import from "
          f"{HERE / 'src'}: {e}", file=sys.stderr)
    sys.exit(3)

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
L2_BYTES = 50e6                # H100 L2 cache; timed inputs rotate past it
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
F32 = torch.float32
STEPS = 5                      # train steps on the main path
SEED = 0                       # of the synthetic batch


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


ENC2D = [(1, 8, 1), (3, 64, 2), (5, 640, 4), (8, 1024, 8), (31, 96, 3),
         (2, 1001, 7), (1, 171737, 2)]
ENC3D = [(3, 16, 2, 128), (4, 256, 2, 64), (2, 40, 5, 96), (2, 7, 3, 33),
         (1, 3072, 2, 2048)]
DEC2D = [(4, 64, 2), (16, 512, 3), (32, 96, 8), (10, 1280, 1), (12, 1001, 19),
         (64, 77, 32), (8, 171776, 2)]
DEC3D = [(4, 32, 2, 128), (16, 128, 4, 64), (5, 9, 11, 17), (8, 3072, 2048)]


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
    errs = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0,
                "max_abs_err_vs_einsum": 0.0, "max_abs_err_bf16": 0.0,
                "max_abs_err_bf16_vs_einsum": 0.0, "cases": 0}
            for k in ops.launch_counts()}

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
            for shape, m in [(s[:2], s[2]) for s in DEC2D] + \
                            [((s[0], s[1], s[3]), s[2]) if len(s) == 4
                             else (s, 2) for s in DEC3D]:
                Fm = _randn(gen, shape, dtype)
                W = _randn(gen, (shape[0], m), dtype)
                name = "coded_decode_3d" if len(shape) == 3 else "coded_decode_2d"
                note(name, dtype, _compare(coded_decode, coded_decode_plain,
                                           Fm, W, out_dtype, dtype))
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
    return errs


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


def _bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def measure(kind, shape, m=None, dtype=F32, out_dtype=F32):
    """ms / plain_ms / library_ms / bound_ms of one kernel at one shape.

    ``bound_ms`` takes the bytes from device memory, so the three times are
    read on inputs that are not in the L2 cache: each call gets the next of
    enough copies of the large operand to pass twice the cache's size before
    one comes round again.  ``ms_l2_warm`` is the kernel on one copy, every
    call, as the train step finds an operand that was written just before."""
    gen = torch.Generator().manual_seed(1)
    isz, osz = torch.empty((), dtype=dtype).element_size(), \
        torch.empty((), dtype=out_dtype).element_size()
    n_in = int(np.prod(shape))
    copies = max(2, int(2 * L2_BYTES // (n_in * isz)) + 1)
    big = [_randn(gen, shape, dtype) for _ in range(copies)]
    if kind == "encode":
        kernel, plain = coded_encode, coded_encode_plain
        coef = _randn(gen, (shape[0], shape[2]), F32)
        n_out = n_in // (shape[0] * shape[2])
        flops = 2 * n_in
    else:
        kernel, plain = coded_decode, coded_decode_plain
        coef = _randn(gen, (shape[0], m), F32)
        n_out = n_in // shape[0] * m
        flops = 2 * n_in * m
    nbytes = n_in * isz + n_out * osz
    bound_ms, bound_by = _bound(nbytes, flops)
    ms = time_ms(lambda i: kernel(big[i % copies], coef, out_dtype=out_dtype))
    plain_ms = time_ms(lambda i: plain(big[i % copies], coef, out_dtype=out_dtype))
    library_ms = time_ms(lambda i: _einsum(kernel, big[i % copies], coef, out_dtype))
    ms_warm = time_ms(lambda i: kernel(big[0], coef, out_dtype=out_dtype))
    return {"shape": list(shape) + ([m] if m else []),
            "dtype": str(dtype).split(".")[-1],
            "out_dtype": str(out_dtype).split(".")[-1],
            "bytes": nbytes, "input_copies": copies, "ms": ms,
            "ms_l2_warm": ms_warm, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "achieved_GBps": nbytes / (ms * 1e-3) / 1e9}


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


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def profile_steps(tr, batch, step_ms, steps=3):
    """Where a train step's time goes: ``torch.profiler`` over a few more
    steps gives the device-busy time and the kernels that fill it; the idle
    share is taken against ``step_ms``, the step's wall time measured
    without the profiler (tracing slows the host many times over)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tr.step(batch)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        fail("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / steps
    say(phase="profile", steps=steps, step_ms_unprofiled=step_ms,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1.0 - busy_ms / step_ms,
        top_device_kernels=[{"name": k[:90], "ms_per_step": ms / steps,
                             "calls_per_step": c / steps}
                            for k, ms, c in rows[:12]])


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
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in logs]
    if not all(np.isfinite(list(m.values())).all() for m in logs):
        fail(f"non-finite metrics: {logs}")
    # NAG's lambda sequence starts at 0, so its first step leaves the carried
    # point where it was: the loss moves from the second step on
    if not (losses[-1] < losses[0]
            and all(b < a for a, b in zip(losses[1:], losses[2:]))):
        fail(f"loss does not decrease: {losses}")
    want = {"coded_encode_2d": STEPS * code.n * code.d,
            "coded_decode_2d": STEPS, "coded_encode_3d": 0,
            "coded_decode_3d": 0}
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

    # ---- the second counted path, with counts of its own: a generic
    # parameter dict whose leaves keep trailing dims
    params, loss_fn, mbatch = _mlp_case()
    placed = CodedBatcher(code).place(mbatch)
    grads = {}
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    for key, spec in (("leaf", coding.SchemeSpec(packed=False)),
                      ("packed", coding.SchemeSpec()),
                      ("ref", coding.SchemeSpec(packed=False, backend="ref"))):
        if key == "ref":
            torch.cuda.synchronize()
            counts_mlp = ops.launch_counts()      # read just after the drive
        arts = make_coded_train_step(None, code, sgd_momentum(1e-3),
                                     loss_fn=loss_fn, params_like=params,
                                     grad_scale=1.0, spec=spec)
        inp = arts.step_inputs((2, 5))
        grads[key], _ = arts.aggregate(params, placed, inp["W"], inp["mask"],
                                       inp["rho"])
    torch.cuda.synchronize()
    # per leaf and packed alike, each worker encodes each of its d subset
    # gradients leaf by leaf: w1 and w2 through the 3D kernel, b through the
    # 2D one; per leaf every leaf is decoded alone, packed the one bucket is
    per_drive = code.n * code.d
    want = {"coded_encode_2d": 2 * per_drive, "coded_encode_3d": 4 * per_drive,
            "coded_decode_2d": 1 + 1, "coded_decode_3d": 2}
    if counts_mlp != want:
        fail(f"generic step: kernel launches {counts_mlp}, the two drives "
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
    if args.profile:
        profile_steps(tr, batch, statistics.median(steps_ms[1:]))
    return {"logistic-paper Trainer.step": counts_train,
            "mlp make_coded_train_step": counts_mlp}


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
        nvidia_smi=smi)

    _build.load()
    say(phase="build", **_build.last_build,
        sources=[str(p.relative_to(HERE)) for p in _build.sources()])

    errs = check_kernels()
    main_shapes = {
        "coded_encode_2d": measure("encode", (1, 171737, 2)),
        "coded_encode_3d": measure("encode", (1, 3072, 2, 2048)),
        "coded_decode_2d": measure("decode", (8, 171776), m=2),
        "coded_decode_3d": measure("decode", (8, 3072, 2048), m=2),
    }
    other_shapes = {
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
    say(phase="kernels_check", tolerance={"f32": 2e-5, "bf16": 2e-2},
        errors=errs, at_main_path_shapes=main_shapes, at_other_shapes=other_shapes)

    counts = run_main_path(args)
    # each kernel's launches are those of the path that runs it: the 2D pair
    # on logistic-paper (one flat leaf), the 3D pair on the MLP's matrices
    trainer_path, mlp_path = counts
    path_of = {"coded_encode_2d": trainer_path, "coded_decode_2d": trainer_path,
               "coded_encode_3d": mlp_path, "coded_decode_3d": mlp_path}

    replaces = {"coded_encode_2d": "src/repro/kernels/coded_encode.py:76",
                "coded_encode_3d": "src/repro/kernels/coded_encode.py:93",
                "coded_decode_2d": "src/repro/kernels/coded_decode.py:59",
                "coded_decode_3d": "src/repro/kernels/coded_decode.py:73"}
    kernels = []
    for name, meas in main_shapes.items():
        stem = name.rsplit("_", 1)[0]
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
        if kernels[-1]["launches"] == 0:
            fail(f"kernel {name} was not launched on its path, {path_of[name]}")
    report = {"kernels": kernels, "launches_by_path": counts}
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
