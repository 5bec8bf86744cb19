"""Batched serving on the PyTorch/CUDA port: prefill a batch of prompts into
a KV cache and greedily decode new tokens with the ``BatchedEngine``.

The twin of ``examples/serve_batched.py``: the same flags and defaults, the
reduced config of ``--arch``, weights from ``api.init`` with seed 0, seeded
prompts, and the same printed lines.  It differs in:

- the device: the engine runs on one device (``BatchedEngine(cfg, params,
  batch=, seq_len=, window=, device=)``), the card by default;
  ``--device cpu`` runs the plain PyTorch versions on the host.  There is
  no host-device mesh (the reference shards over a (4, 2) one) and no
  ``XLA_FLAGS`` preamble.
- the weights: ``api.init(cfg, device, generator)`` draws them on the
  device from a ``torch.Generator`` seeded 0, so they are not the
  reference's ``PRNGKey(0)`` draws.
- the wall clock ends at ``generate``'s return, whose tokens are on the
  host (so after a device sync).

``run()`` is the library form: it takes any config (the full one too),
returns what the script prints, the tokens, the prompts and the weights
(the port's dict of tensors on the device).

  PYTHONPATH=src python examples/serve_batched_torch.py --arch qwen3-1.7b
  PYTHONPATH=src python examples/serve_batched_torch.py --arch xlstm-350m
  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.serving import BatchedEngine


def run(cfg=None, *, arch: str = "qwen3-1.7b", batch: int = 8,
        prompt_len: int = 32, max_new: int = 16, window: int = 0,
        device: str | torch.device = "cuda", params=None,
        echo=None) -> dict:
    """Generate ``max_new`` greedy tokens for ``batch`` seeded prompts of
    ``prompt_len`` tokens on ``cfg`` (default: ``arch``'s reduced config),
    in a cache of ``prompt_len + max_new + 8`` positions (a ring of
    ``window`` when > 0).  The weights are ``params`` (numpy, the
    reference's tree) when given, else drawn by ``api.init`` from seed 0
    on the device.  ``echo`` (e.g. ``print``) gets the
    reference's lines.  Returns ``name``, ``tokens`` ((batch, max_new)
    int32), ``prompts``, ``wall_s``, ``tok_per_s`` and ``params``."""
    say = echo or (lambda *_: None)
    dev = resolve_device(device)
    cfg = cfg or get_config(arch).reduced()
    params = (api.init(cfg, dev, torch.Generator(dev).manual_seed(0))
              if params is None else convert.params_from_jax(params, device=dev))
    engine = BatchedEngine(cfg, params, batch=batch,
                           seq_len=prompt_len + max_new + 8, window=window,
                           device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len), dtype=np.int32)
    t0 = time.time()
    out = engine.generate(prompts, max_new)
    dt = time.time() - t0
    say(f"arch={cfg.name} batch={batch} new_tokens={max_new} wall={dt:.1f}s "
        f"({batch * max_new / dt:.1f} tok/s)")
    say("sample continuations (token ids):")
    for row in out[:3]:
        say("  ", row.tolist())
    return {"name": cfg.name, "tokens": out, "prompts": prompts,
            "wall_s": dt, "tok_per_s": batch * max_new / dt,
            "params": engine.params, "device": str(dev)}


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` (default: the command line), generate with the
    reference's lines printed, and return ``run``'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: sliding-window cache (the long_500k path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
               max_new=args.max_new, window=args.window, device=args.device,
               echo=print)


if __name__ == "__main__":
    main()
