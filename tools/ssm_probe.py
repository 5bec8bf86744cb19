#!/usr/bin/env python3
"""Where the time of ``xlstm-350m`` (or, with ``--arch zamba2-1.2b``, the
hybrid ``zamba2-1.2b``) goes on one NVIDIA GPU (written for an H100), at
full width and full depth (24 / 38 layers, f32, seeded random weights,
TF32 off):

    python3 tools/ssm_probe.py [--arch xlstm-350m] [--seq 4096]
                               [--serve-seq 512 1024] [--train-seq 512]
                               [--gen-batch 4] [--decode-steps 16]
                               [--gap-depths 2 8 24] [--gap-steps 0 1 15]
                               [--parts PART ...]

For ``zamba2-1.2b`` the defaults are ``--serve-seq 4096 --train-seq 4096
--gap-depths 2 8 38 --gap-steps 0 3 7``: its SSD scan is chunked (no step
a token), and the checked decode steps give the forward over the prompt
and the tokens so far lengths with large chunks (the chunk is the largest
divisor of the length up to ``ssm_chunk``).

- ``forward``: the uncoded forward of one prompt of ``--seq`` tokens
  (``api.make_forward``, the stateless forward coded serving replicates),
  its wall time up to a device sync (a warm-up call first, then two timed),
  against the time its products would take at the card's f32 rate and at
  the SGEMM rate the dense paths reach (PERF.md section 5).  Then one more
  call under ``torch.profiler``: the device busy time (the union of the
  kernels' intervals), the idle share against the unprofiled wall, and the
  launches by kernel name.
- ``serve_prefill``: the same forward at each ``--serve-seq``, two timed
  calls each: one prefill of the coded serve batch, which runs twelve.
- ``subset_grad``: the loss and gradient of one sequence of
  ``--train-seq`` tokens (one subset of a coded training step), the sLSTM
  through the package's hand-written backward (``xlstm._SLSTMScan``) and
  through autograd recording the cell's steps as plain operations (the
  same arithmetic), in turns (scan,
  autograd, autograd, scan): wall time and peak memory of each, and the
  largest gap between the two gradients relative to each leaf's largest
  element.  For the hybrid, two timed calls and their peak memory.
- ``generate``: a prefill of ``--gen-batch`` prompts of the largest
  ``--serve-seq`` and ``--decode-steps`` decode steps (ms a step between
  CUDA events recorded as each is enqueued, median of steps 2 on).
- ``decode_gap``: at each of ``--gap-depths`` (the first layers of the
  same weights), decode steps ``--gap-steps`` against the chunked forward
  (``last_logits``) over the prompt and the tokens so far: the largest
  difference relative to the largest logit; beside it the same forward
  with ``ssm_chunk`` halved against it (the same function rounded another
  way: what the model's conditioning does to f32 rounding).

- ``subset_grad_profile`` (hybrid): one more gradient of the first
  ``--train-seq`` under ``torch.profiler``: device busy time, idle share
  against the median timed wall, launches by kernel.

``--train-seq`` takes several lengths (``subset_grad`` times each).
``--parts`` picks some of ``forward serve_prefill subset_grad generate
decode_gap forward_profile subset_grad_profile`` (all by default).
Prints one JSON line a part, then the card's name and power limit as
``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import pathlib
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import mamba_hybrid, xlstm  # noqa: E402

ARCHS = ("xlstm-350m", "zamba2-1.2b")
F32_FLOP_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
SGEMM_FLOP_PER_S = 50e12       # the f32 SGEMM rate of the dense paths


def say(**obj):
    print(json.dumps(obj), flush=True)


def forward_flops(cfg, T: int) -> int:
    """Multiply-adds (x 2) of one prompt's forward of ``T`` tokens: the
    projections, the mLSTM's intra-chunk and state products, the sLSTM's
    recurrent products and the last position's unembedding; for the hybrid
    the Mamba2 projections, the SSD chunk products (C B, the intra-chunk
    mix, the state read and written), the shared block at each application
    (its causal attention over T (T + 1) / 2 pairs) and the unembedding."""
    if cfg.family == "hybrid":
        D, Di, H, hd, N = mamba_hybrid._dims(cfg)
        cl = xlstm._chunk_len(cfg.ssm_chunk, T)
        E = 2 * Di + 2 * N + H
        mamba = T * (D * E + Di * D) + T * (cl * N + H * cl * hd
                                            + 2 * H * hd * N)
        Hq, Hkv, ahd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        attn = T * D * (Hq + 2 * Hkv) * ahd + T * Hq * ahd * D \
            + 2 * Hq * ahd * T * (T + 1) // 2 + 3 * T * D * cfg.d_ff
        apps = len(mamba_hybrid._group_slices(cfg))
        return 2 * (cfg.n_layers * mamba + apps * attn + D * cfg.vocab)
    D, Di, H, hd = xlstm._dims(cfg)
    cl = xlstm._chunk_len(cfg.ssm_chunk, T)
    mlstm = (D * 2 * Di + 3 * Di * Di + 2 * Di * H + Di * D
             + H * (cl * hd * 2 + 2 * hd * hd + hd * hd))
    slstm = D * Di + 4 * Di * Di + H * hd * 4 * hd + Di * D
    return 2 * (T * cfg.n_layers // 2 * (mlstm + slstm) + D * cfg.vocab)


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def profile_once(fn, wall_s):
    """Device busy time, idle share against ``wall_s`` and launches by
    kernel of one call of ``fn``, from the device's activity alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1,
                               us + e.time_range.end - e.time_range.start)
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"device_busy_s": busy / 1e6,
            "device_idle_share": 1.0 - busy / 1e6 / wall_s,
            "launches": len(spans),
            "top_kernels": [{"name": k[:90], "launches": n, "ms": us / 1e3}
                            for k, (n, us) in rows[:16]]}


PARTS = ("forward", "serve_prefill", "subset_grad", "generate", "decode_gap",
         "forward_profile", "subset_grad_profile")


def _loop_apply(x4, R, h, c, n, m):
    """``_SLSTMScan.apply``'s outputs from the cell's steps spelled as plain
    operations, recorded by autograd."""
    hd = x4.shape[-1] // 4
    hs = []
    for x in torch.unbind(x4):
        pz, pi, pf, po = torch.split(torch.baddbmm(x, h, R), hd, dim=-1)
        a = torch.nn.functional.logsigmoid(pf) + m
        m = torch.maximum(a, pi)
        ip, fp = torch.exp(torch.stack([pi, a]) - m)
        c = torch.addcmul(fp * c, ip, torch.tanh(pz))
        n = torch.addcmul(ip, fp, n)
        h = torch.sigmoid(po) * c / torch.maximum(n, torch.ones_like(n))
        hs.append(h)
    return torch.stack(hs), c, n, m


def subset_grad(params, cfg, batch):
    """The loss and gradient of one sequence, ``xlstm.loss`` as the coded
    step runs it, with the sLSTM's steps through ``_SLSTMScan`` (scan) or
    through autograd recording the loop, in turns."""
    loss = model_api.make_loss(cfg)
    runs, grads = {"scan": [], "autograd": []}, {}
    scan = xlstm._SLSTMScan.apply
    for how in ("scan", "autograd", "autograd", "scan"):
        xlstm._SLSTMScan.apply = scan if how == "scan" else _loop_apply
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            s, g = wall(lambda: torch.autograd.grad(loss(p, batch),
                                                    list(p.values())))
        finally:
            xlstm._SLSTMScan.apply = scan
        runs[how].append((s, torch.cuda.max_memory_allocated() - base))
        grads[how] = g
        del g
    gap = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(grads["scan"], grads["autograd"]))
    return {f"{k}_wall_s": [r[0] for r in v] for k, v in runs.items()} | {
        f"{k}_peak_bytes_over_weights": [r[1] for r in v]
        for k, v in runs.items()} | {"max_rel_gap_scan_vs_autograd": gap}


def hybrid_subset_grad(params, cfg, batch):
    """The loss and gradient of one sequence, ``mamba_hybrid.loss`` as the
    coded step runs it (each layer and shared-block application
    checkpointed), twice: wall time and peak memory over the weights."""
    loss = model_api.make_loss(cfg)
    runs = []
    for _ in range(2):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        s, g = wall(lambda: torch.autograd.grad(loss(p, batch),
                                                list(p.values())))
        runs.append((s, torch.cuda.max_memory_allocated() - base))
        del g
    return {"wall_s": [r[0] for r in runs],
            "peak_bytes_over_weights": [r[1] for r in runs]}


def decode_gap(params, cfg, prompts, steps, depths, checked):
    """Decode steps ``checked`` against the chunked forward over the
    prompt and the tokens so far, at each depth (the first layers)."""
    mod = model_api.get_module(cfg)
    hybrid = cfg.family == "hybrid"
    out = {}
    for L in depths:
        c = dataclasses.replace(cfg, n_layers=L)
        p = {k: (v[:L] if k.startswith("mamba/") else v) if hybrid else
             (v[:L // 2] if k.startswith("pairs/") else v)
             for k, v in params.items()}
        logits, state = model_api.make_prefill(
            c, prompts["tokens"].shape[1] + steps)(p, prompts)
        toks = [prompts["tokens"]]
        gaps = {}
        for t in range(steps):
            toks.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
            logits, state = model_api.make_decode(c)(p, state, toks[-1][:, 0])
            if t in checked:
                seq = torch.cat(toks, dim=1)
                want = mod.last_logits(p, c, seq)
                other = mod.last_logits(p, dataclasses.replace(
                    c, ssm_chunk=c.ssm_chunk // 2), seq)
                scale = want.abs().max()
                gaps[str(t)] = {
                    "forward_len": seq.shape[1],
                    "chunk": xlstm._chunk_len(c.ssm_chunk, seq.shape[1]),
                    "decode": float((logits - want).abs().max() / scale),
                    "half_chunk_forward": float((other - want).abs().max()
                                                / scale)}
        out[str(L)] = gaps
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--serve-seq", type=int, nargs="+")
    ap.add_argument("--train-seq", type=int, nargs="+")
    ap.add_argument("--gen-batch", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--gap-depths", type=int, nargs="+")
    ap.add_argument("--gap-steps", type=int, nargs="+")
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=PARTS)
    args = ap.parse_args()
    hybrid = args.arch == "zamba2-1.2b"
    for name, xl, hy in (("serve_seq", [512, 1024], [4096]),
                         ("train_seq", [512], [4096]),
                         ("gap_depths", [2, 8, 24], [2, 8, 38]),
                         ("gap_steps", [0, 1, args.decode_steps - 1],
                          [0, 3, 7])):
        if getattr(args, name) is None:
            setattr(args, name, hy if hybrid else xl)
    if not torch.cuda.is_available():
        print("ssm_probe: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    params = model_api.init(cfg, dev,
                            torch.Generator(device=dev).manual_seed(0))
    forward = model_api.make_forward(cfg)
    rng = np.random.default_rng(0)

    def prompt(B, T):
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, T), dtype=np.int32)).to(dev)}

    batch, times = prompt(1, args.seq), None
    with torch.no_grad():
        if "forward" in args.parts or "forward_profile" in args.parts:
            warm_s, _ = wall(lambda: forward(params, batch))
            times = [wall(lambda: forward(params, batch))[0] for _ in range(2)]
            flops = forward_flops(cfg, args.seq)
            say(part="forward", arch=cfg.name, seq=args.seq, batch=1,
                n_layers=cfg.n_layers,
                d_model=cfg.d_model, warmup_s=warm_s, wall_s=times,
                flops=flops, flop_time_s_at_67_tflops=flops / F32_FLOP_PER_S,
                flop_time_s_at_50_tflops=flops / SGEMM_FLOP_PER_S)
        if "serve_prefill" in args.parts:
            for T in args.serve_seq:
                b = prompt(1, T)
                wall(lambda: forward(params, b))
                say(part="serve_prefill", seq=T,
                    wall_s=[wall(lambda: forward(params, b))[0]
                            for _ in range(2)],
                    flop_time_s_at_50_tflops=forward_flops(cfg, T)
                    / SGEMM_FLOP_PER_S)

    grad_s = None
    if "subset_grad" in args.parts:
        for T in args.train_seq:
            tb = prompt(1, T)
            tb["labels"] = torch.roll(tb["tokens"], -1, dims=1)
            res = (hybrid_subset_grad if hybrid else subset_grad)(params,
                                                                  cfg, tb)
            grad_s = grad_s or res.get("wall_s")
            say(part="subset_grad", seq=T, **res)
    if "subset_grad_profile" in args.parts and hybrid:
        tb = prompt(1, args.train_seq[0])
        tb["labels"] = torch.roll(tb["tokens"], -1, dims=1)
        loss = model_api.make_loss(cfg)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}

        def grad():
            return torch.autograd.grad(loss(p, tb), list(p.values()))

        s, _ = wall(grad)
        say(part="subset_grad_profile", seq=args.train_seq[0],
            **profile_once(grad, min(grad_s or [s])))

    T = max(args.serve_seq)
    with torch.no_grad():
        if "generate" in args.parts:
            gb = prompt(args.gen_batch, T)
            pre = model_api.make_prefill(cfg, T + args.decode_steps)
            dec = model_api.make_decode(cfg)
            pre(params, gb)
            pre_s, (logits, state) = wall(lambda: pre(params, gb))
            tok = torch.argmax(logits, -1).to(torch.int32)
            events = []
            for _ in range(args.decode_steps):
                logits, state = dec(params, state, tok)
                tok = torch.argmax(logits, -1).to(torch.int32)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            torch.cuda.synchronize()
            step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            say(part="generate", batch=args.gen_batch, prompt=T,
                prefill_s=pre_s, decode_step_ms=step_ms,
                decode_step_ms_median=statistics.median(step_ms[1:]),
                state_bytes=sum(v.numel() * v.element_size()
                                for v in state.values()))
            del state
        if "decode_gap" in args.parts:
            say(part="decode_gap", batch=args.gen_batch,
                prompt=min(args.serve_seq), steps=args.decode_steps,
                rel_gap_by_depth=decode_gap(
                    params, cfg, prompt(args.gen_batch, min(args.serve_seq)),
                    args.decode_steps, args.gap_depths, args.gap_steps))
        if "forward_profile" in args.parts:
            prof = profile_once(lambda: forward(params, batch),
                                statistics.median(times))
            say(part="forward_profile", seq=args.seq, **prof)
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(res.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
