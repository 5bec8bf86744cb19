#!/usr/bin/env python3
"""A KV-cache decode step of ``qwen3-1.7b`` at full width with and without
its per-layer host syncs, on one NVIDIA GPU (written for an H100):

    python3 tools/decode_step_ab.py [--steps 16] [--rounds 2]

"sync" puts back the two helpers as they were before the decode was
ported: ``apply_rope`` copied its frequencies from the host on every call
and ``gqa_scores_attend`` made its ``-1e30`` fill a host tensor copied to
the card, each copy a blocking transfer that waits for the device (two a
layer, 56 a step).  "package" is the package's own code, which makes the
frequencies once a device and fills with a scalar.  Both run the same
decode steps from one prefill of 4 prompts of 4096 tokens (f32, 28 layers,
seeded random weights, TF32 off): the cache position is reset before each
run, so every run writes and reads the same slots.  The first step's
logits must be the same bits both ways.  Timed in turns (sync, package,
package, sync for each round): each step's time between CUDA events
recorded as it is enqueued, median over the run.  Prints one JSON line a
round, then the card's name and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import dense  # noqa: E402

PROMPT = 4096


def _rope_sync(x, pos, theta):
    hd = x.shape[-1]
    freqs = torch.as_tensor(cm.rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = pos.to(torch.float32)[..., None] * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _scores_sync(q, k, v, mask, q_per_kv):
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, q_per_kv, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k).to(torch.float32)
    logits = logits / np.sqrt(hd)
    if mask.ndim == 2:
        mask = mask[None]
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(B, Sq, H, hd)


@contextlib.contextmanager
def with_syncs():
    old = cm.apply_rope, cm.gqa_scores_attend
    cm.apply_rope, cm.gqa_scores_attend = _rope_sync, _scores_sync
    try:
        yield
    finally:
        cm.apply_rope, cm.gqa_scores_attend = old


def run(params, cfg, cache, tok, steps):
    """``steps`` decode steps from position PROMPT; per-step ms, first
    logits."""
    cache["pos"] = torch.tensor(PROMPT, dtype=torch.int32, device=tok.device)
    events, first = [], None
    torch.cuda.synchronize()
    for i in range(steps + 1):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if i == steps:
            break
        logits, cache = dense.decode_step(params, cfg, cache, tok)
        if first is None:
            first = logits
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])], first


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_step_ab: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen3-1.7b")
    params = model_api.init(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (4, PROMPT), dtype=np.int32)).to(dev)
    with torch.no_grad():
        logits, cache = dense.prefill(params, cfg, prompts,
                                      PROMPT + args.steps)
    tok = logits.argmax(-1).to(torch.int32)
    run(params, cfg, cache, tok, 2)                      # warm both ways
    with with_syncs():
        run(params, cfg, cache, tok, 2)
    for r in range(args.rounds):
        res = {}
        for mode in ("sync", "package", "package", "sync"):
            with (with_syncs() if mode == "sync" else contextlib.nullcontext()):
                ms, first = run(params, cfg, cache, tok, args.steps)
            res.setdefault(mode, []).append(statistics.median(ms))
            res.setdefault(f"{mode}_first", first)
        same = torch.equal(res.pop("sync_first").view(torch.int32),
                           res.pop("package_first").view(torch.int32))
        if not same:
            print("decode_step_ab: the two ways give other bits",
                  file=sys.stderr)
            sys.exit(1)
        print(json.dumps({"round": r, "steps": args.steps,
                          "median_step_ms": res,
                          "first_logits_same_bits": same}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
