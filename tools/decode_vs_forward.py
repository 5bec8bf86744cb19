#!/usr/bin/env python3
"""Where a KV-cache decode step's logits part from the full-prompt forward,
on one NVIDIA GPU (written for an H100), for ``qwen3-1.7b`` at full width:

    python3 tools/decode_vs_forward.py [--layers 1 7 28] [--prompt 4096]

For each depth (the first ``L`` layers of the seeded random weights, f32,
TF32 off), 4 prompts from a seed and one greedy token:

  decode   the prefill of the prompt (flash attention above 2048 tokens,
           the port's path) and one ``decode_step`` (the materialized f32
           softmax over the cache); also the same step from a prefill whose
           attention is the materialized f32 softmax ("exact")
  forward  ``dense.last_logits`` of prompt ++ token twice: through the
           flash kernel (3xTF32, the port's path above 2048 tokens) and
           with the materialized f32 softmax at every length ("exact")

and prints, per depth, the largest |difference| of each pair and how far
each exceeds ``atol + rtol * |reference|`` at rtol = atol = 2e-4
(``tests/test_models_math.py``'s tolerance; <= 0 is within it).  Then the
card's name and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
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

TOL = 2e-4


@contextlib.contextmanager
def exact_attention():
    """The materialized f32 softmax at every length (no flash kernel)."""
    old = cm.CHUNK_THRESHOLD
    cm.CHUNK_THRESHOLD = 1 << 40
    try:
        yield
    finally:
        cm.CHUNK_THRESHOLD = old


def compare(got, want):
    err = (got - want).abs()
    return {"max_abs_err": err.max().item(),
            "excess_over_tol": (err - TOL - TOL * want.abs()).max().item()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 7, 28])
    ap.add_argument("--prompt", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_vs_forward: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    full = get_config("qwen3-1.7b")
    params = model_api.init(full, dev, torch.Generator(device=dev).manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(11).integers(
        0, full.vocab, (4, args.prompt), dtype=np.int32)).to(dev)
    for L in args.layers:
        cfg = dataclasses.replace(full, n_layers=L)
        p = {k: (v[:L] if k.startswith("layers/") else v)
             for k, v in params.items()}
        out = {}
        with torch.no_grad():
            for name, ctx in (("flash", contextlib.nullcontext),
                              ("exact", exact_attention)):
                with ctx():
                    lg, cache = dense.prefill(p, cfg, prompts, args.prompt + 1)
                    tok = lg.argmax(-1).to(torch.int32)
                    out[f"decode_after_{name}_prefill"], _ = dense.decode_step(
                        p, cfg, cache, tok)
                    del cache
                    seq = torch.cat([prompts, tok[:, None]], dim=1)
                    out[f"forward_{name}"] = dense.last_logits(p, cfg, seq)
        torch.cuda.synchronize()
        pairs = {
            "decode_vs_forward_flash": ("decode_after_flash_prefill",
                                        "forward_flash"),
            "decode_vs_forward_exact": ("decode_after_flash_prefill",
                                        "forward_exact"),
            "decode_exact_prefill_vs_forward_exact": (
                "decode_after_exact_prefill", "forward_exact"),
            "forward_flash_vs_forward_exact": ("forward_flash",
                                               "forward_exact"),
        }
        print(json.dumps({
            "layers": L, "prompt": args.prompt,
            "max_abs_logit": out["forward_exact"].abs().max().item(),
            **{k: compare(out[a], out[b]) for k, (a, b) in pairs.items()}}),
            flush=True)
        del out
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
