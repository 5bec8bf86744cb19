"""Coded-training launcher: the port's twin of ``python -m
repro.launch.train``, with the same flags and defaults.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --reduced --n-data 4 --d 3 --s 1 --m 2 --steps 20 --schedule gather

The ``n_data`` workers are one worker group on one device (the card by
default: ``--device cuda`` raises when there is none; ``--device cpu`` runs
the plain PyTorch versions).  The port runs one card with a model axis of
1, so ``--n-model`` must be 1.
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> list[dict]:
    """Parse ``argv`` (default: the command line), train, print the final
    loss line, and return the per-step metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--n-data", type=int, default=4)
    ap.add_argument("--n-model", type=int, default=1)
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--s", type=int, default=1)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--schedule", default="gather",
                    choices=["gather", "a2a", "psum"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-per-subset", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--stragglers", default="random",
                    choices=["none", "random", "fixed"])
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.n_model != 1:
        ap.error(f"--n-model {args.n_model}: the port runs one card with "
                 f"n_model = 1 (the model axis is not sharded)")

    from .. import coding
    from .._device import resolve_device
    from ..configs import get_config
    from ..core import make_code
    from ..data import synthetic_lm_stream
    from ..optim import get_optimizer
    from ..train import Trainer
    from ..tune import FixedStragglers, NoStragglers, RandomStragglers

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    code = make_code(args.n_data, args.d, args.s, args.m)
    source = {"none": NoStragglers(), "random": RandomStragglers(seed=1),
              "fixed": FixedStragglers(())}[args.stragglers]
    trainer = Trainer(cfg, code, get_optimizer(args.optimizer, args.lr),
                      spec=coding.SchemeSpec(schedule=args.schedule),
                      straggler_source=source, device=device)
    gb = args.n_data * args.batch_per_subset
    stream = synthetic_lm_stream(cfg, gb, args.seq)
    logs = trainer.run(stream, args.steps, log_every=max(1, args.steps // 10),
                       log_path=args.log)
    print(f"final loss {logs[-1]['loss']:.4f} "
          f"(coded fraction {trainer.arts.coded_fraction:.3f})")
    return logs


if __name__ == "__main__":
    main()
