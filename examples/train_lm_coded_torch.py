"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter dense
LM with coded gradient aggregation for a few hundred steps.

Default invocation trains a scaled-down model for a fast demo; pass
``--full-100m`` for the ~100M configuration:

  PYTHONPATH=src python examples/train_lm_coded_torch.py --steps 300 --full-100m
  PYTHONPATH=src python examples/train_lm_coded_torch.py --steps 40        # demo
  PYTHONPATH=src python examples/train_lm_coded_torch.py --device cpu --steps 4

The twin of ``examples/train_lm_coded.py``: the same two configurations
(``dataclasses.replace`` on ``qwen3-1.7b``), AdamW at 3e-4, random
stragglers, ``Trainer.run`` with a log line every 10 steps, and the same
flags and defaults and printed lines.  It differs in:

- the device: the ``n_data`` workers are the port's single-process worker
  group on one device (``Trainer(cfg, code, optimizer, device=...)`` over
  ``LocalComm``), the card by default; ``--device cpu`` runs the plain
  PyTorch versions on the host.  No host-device mesh, no ``XLA_FLAGS``.
- ``--n-model`` is dropped: the port shards no model axis
  (``n_model = 1``).
- ``--backend``: the port's names, ``auto``, ``ref`` or ``hopper``, in
  place of ``pallas`` and ``interpret``.
- ``--log`` defaults to ``results/train_lm_coded_torch.json`` (the
  reference's schema: the list of per-step metrics).

``run()`` is the library form; it returns what the script prints and the
per-step metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from repro_torch import coding, convert, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import make_code
from repro_torch.data import synthetic_lm_stream
from repro_torch.optim import get_optimizer
from repro_torch.train import Trainer
from repro_torch.tune import RandomStragglers


def demo_config():
    """The scaled-down demo model: the reduced ``qwen3-1.7b`` at 4 layers."""
    return dataclasses.replace(
        get_config("qwen3-1.7b").reduced(), name="coded-lm-demo", n_layers=4,
        d_model=256, vocab=2048)


def full_100m_config():
    """~100M params: 12L, d_model 768, 12 heads, vocab 32k."""
    return dataclasses.replace(
        get_config("qwen3-1.7b"), name="coded-lm-100m", n_layers=12,
        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000,
        head_dim=64)


def run(cfg=None, *, steps: int = 40, schedule: str = "gather",
        backend: str = "auto", n_data: int = 4, d: int = 3, s: int = 1,
        m: int = 2, seq: int = 256, batch_per_subset: int = 4,
        log: str | None = None, log_every: int = 10,
        device: str | torch.device = "cuda", params=None, echo=None) -> dict:
    """Train ``cfg`` (default: the demo config) for ``steps`` steps with
    code ``(n_data, d, s, m)`` on the synthetic LM stream, a step line
    every ``log_every`` steps (0: none); ``log`` the JSON path of the
    per-step metrics (none when None).  Starts from ``params`` (numpy, the
    reference's tree) when given, else from the trainer's seed 0.
    ``echo`` (e.g. ``print``) gets the reference's lines as they come.
    Returns ``name``, ``n_params``, ``describe`` and ``logs``."""
    say = echo or (lambda *_: None)
    dev = resolve_device(device)
    cfg = cfg or demo_config()
    code = make_code(n_data, d, s, m)
    trainer = Trainer(cfg, code, get_optimizer("adamw", 3e-4),
                      spec=coding.SchemeSpec(schedule=schedule,
                                             backend=backend),
                      straggler_source=RandomStragglers(seed=1), device=dev)
    if params is not None:
        trainer.params = convert.params_from_jax(params, device=trainer.device)
        trainer.opt_state = trainer.optimizer.init(trainer.params)
    n_params = sum(p.numel() for p in trainer.params.values())
    say(f"model {cfg.name}: {n_params / 1e6:.1f}M params; {code.describe()}")
    stream = synthetic_lm_stream(cfg, n_data * batch_per_subset, seq)
    if log:
        os.makedirs(os.path.dirname(log) or ".", exist_ok=True)
    logs = trainer.run(stream, steps, log_every=log_every, log_path=log)
    say(f"done: loss {logs[0]['loss']:.3f} -> {logs[-1]['loss']:.3f} "
        f"in {logs[-1]['wall']:.0f}s")
    return {"name": cfg.name, "n_params": n_params,
            "describe": code.describe(), "logs": logs, "device": str(dev)}


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` (default: the command line), train with the
    reference's lines printed, and return ``run``'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--schedule", default="gather",
                    choices=["gather", "a2a", "psum"])
    ap.add_argument("--backend", default="auto",
                    choices=list(coding.BACKEND_NAMES),
                    help="codec compute backend (hopper = the CUDA kernels)")
    ap.add_argument("--n-data", type=int, default=4)
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--s", type=int, default=1)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch-per-subset", type=int, default=4)
    ap.add_argument("--log", default="results/train_lm_coded_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(full_100m_config() if args.full_100m else demo_config(),
               steps=args.steps, schedule=args.schedule, backend=args.backend,
               n_data=args.n_data, d=args.d, s=args.s, m=args.m,
               seq=args.seq, batch_per_subset=args.batch_per_subset,
               log=args.log, device=args.device, echo=print)


if __name__ == "__main__":
    main()
