"""Quickstart on the PyTorch/CUDA port: the paper's gradient coding end to
end, then the beyond-paper levers — heterogeneous loads, partial recovery,
and online auto-tuning — on one 4-worker group.

1. uniform (d=3, s=1, m=2) code, GQA transformer, random straggler per step;
2. heterogeneous plan: per-worker loads from a cluster speed vector, same
   decode, same trainer;
3. partial recovery: s+1 fixed stragglers — the step completes and reports
   a certified L2 gradient-error bound instead of aborting;
4. auto-tuning: the straggler distribution drifts mid-run and the trainer
   re-fits the Sec-VI model from telemetry, re-plans (d, s, m), and swaps
   codecs (docs/autotune.md).

The twin of ``examples/quickstart.py``: the same four parts at the same
sizes, codes, optimizer, straggler sources and policy, and the same printed
lines.  It differs in:

- the device: the 4 workers are the port's single-process worker group on
  one device (``Trainer(cfg, code, optimizer, device=...)`` over
  ``LocalComm``), the card by default; ``--device cpu`` runs the plain
  PyTorch versions on the host.  There is no host-device mesh, no
  ``XLA_FLAGS`` preamble and no model axis (the port runs ``n_model = 1``).
- the auto-tuner ranks with the port's own measured step walls, so on
  another machine it may switch at other steps than the reference does.

``run()`` is the library form; it returns what the script prints.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import coding, convert, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import make_code, make_hetero_code
from repro_torch.core.runtime_model import RuntimeParams
from repro_torch.data import synthetic_lm_stream
from repro_torch.optim import get_optimizer
from repro_torch.train import Trainer
from repro_torch.tune import (AutotunePolicy, DriftingSampler,
                              FixedStragglers, RandomStragglers)


def _trainer(cfg, code, spec, source, dev, params, autotune=None):
    """A trainer with AdamW at 3e-3, started from ``params`` (numpy, the
    reference's tree) when given, else from its seed 0."""
    tr = Trainer(cfg, code, get_optimizer("adamw", 3e-3), spec=spec,
                 straggler_source=source, autotune=autotune, device=dev)
    if params is not None:
        tr.params = convert.params_from_jax(params, device=tr.device)
        tr.opt_state = tr.optimizer.init(tr.params)
    return tr


def run(cfg=None, *, steps: int = 20, hetero_steps: int = 10,
        autotune_steps: int = 22, global_batch: int = 8, seq_len: int = 64,
        log_every: int = 5, device: str | torch.device = "cuda",
        params=None, echo=None) -> dict:
    """The four parts on ``cfg`` (default: the reduced ``qwen3-1.7b``), one
    data stream drawn through all of them in order, as the reference does.
    Every trainer starts from ``params`` (numpy, the reference's tree) when
    given, else from its seed 0.  ``echo`` (e.g. ``print``) gets the
    reference's lines as they come; the trainers print their step lines
    every ``log_every`` steps (0: never).  Returns ``uniform``
    (``describe``, ``logs``, ``coded_fraction``), ``hetero``
    (``describe``, ``loads``, ``logs``), ``partial`` (the step's
    ``metrics``, ``s``) and ``autotune`` (``code`` (d, s, m) at the end,
    ``events``, ``switches``, ``cached_schemes``, ``logs``)."""
    say = echo or (lambda *_: None)
    dev = resolve_device(device)
    n, d, s, m = 4, 3, 1, 2
    code = make_code(n, d, s, m)
    say(code.describe())
    # -> each worker computes 3/4 of the data, sends l/2 floats, and the
    #    master tolerates any 1 straggler

    cfg = cfg or get_config("qwen3-1.7b").reduced()   # 2-layer, d_model=256
    spec = coding.SchemeSpec(schedule="gather")
    trainer = _trainer(cfg, code, spec, RandomStragglers(seed=1), dev, params)
    stream = synthetic_lm_stream(cfg, global_batch=global_batch,
                                 seq_len=seq_len)
    logs = trainer.run(stream, steps=steps, log_every=log_every)
    say(f"\ncoded fraction of gradient bytes: "
        f"{trainer.arts.coded_fraction:.3f}")
    say(f"loss: {logs[0]['loss']:.3f} -> {logs[-1]['loss']:.3f} "
        f"(with random stragglers every step)")
    out = {"uniform": {"describe": code.describe(), "logs": logs,
                       "coded_fraction": trainer.arts.coded_fraction}}

    # ---- lever 1: heterogeneous cluster -------------------------------
    # workers run at different speeds: give each a load proportional to its
    # speed (k=8 subsets instead of n=4), same decode, same trainer
    hcode = make_hetero_code(speeds=[0.5, 1.0, 1.0, 1.5], s=1, m=2)
    say(f"\n{hcode.describe()}")
    htrainer = _trainer(cfg, hcode, spec, RandomStragglers(seed=1), dev,
                        params)
    logs = htrainer.run(stream, steps=hetero_steps, log_every=log_every)
    say(f"hetero loads {hcode.loads}: loss {logs[0]['loss']:.3f} -> "
        f"{logs[-1]['loss']:.3f}")
    out["hetero"] = {"describe": hcode.describe(), "loads": hcode.loads,
                     "logs": logs}

    # ---- lever 2: partial recovery past the straggler budget ----------
    # kill s+1 = 2 fixed workers every step: exact decode would raise; the
    # partial step completes and certifies its gradient error instead
    ptrainer = _trainer(cfg, hcode, spec.replace(partial=True),
                        FixedStragglers((0, 3)), dev, params)
    metrics = ptrainer.step(next(stream))
    say(f"\npartial step with {2} stragglers (s={hcode.s}): "
        f"loss {metrics['loss']:.3f}, certified gradient error bound "
        f"{metrics['decode_err_bound']:.3f}")
    out["partial"] = {"metrics": metrics, "s": hcode.s}

    # ---- lever 3: online auto-tuning under drift ----------------------
    # the cluster starts communication-bound (the paper's regime, optimum
    # (4,2,2)) and drifts computation-bound at step 10 (optimum (1,0,1)).
    # The injector stands in for worker heartbeats; the trainer re-fits
    # the shifted-exponential model every 5 steps, re-ranks the (d,s,m) x
    # schedule space, and swaps codecs through its artifact cache.
    comm_heavy = RuntimeParams(n=n, lambda1=0.5, lambda2=0.2, t1=0.5, t2=16.0)
    comp_heavy = RuntimeParams(n=n, lambda1=0.5, lambda2=0.2, t1=16.0, t2=0.5)
    atrainer = _trainer(
        cfg, make_code(n, 4, 2, 2), spec,
        DriftingSampler([(0, comm_heavy), (10, comp_heavy)], seed=3), dev,
        params, autotune=AutotunePolicy(interval=5, window=10, min_samples=5,
                                        schedules=("gather",)))
    logs = atrainer.run(stream, steps=autotune_steps, log_every=0)
    events = atrainer.autotune_events
    switches = sum(e["switched"] for e in events)
    say(f"\nautotune: (4,2,2) -> "
        f"(d={atrainer.code.d},s={atrainer.code.s},m={atrainer.code.m}) "
        f"after drift; {switches} codec swap(s), {atrainer.cached_schemes} "
        f"cached step builds")
    for e in events:
        tag = "switch" if e["switched"] else "hold"
        say(f"  step {e['step']:3d} {tag:6s} -> {e['best']}")
    out["autotune"] = {
        "code": (atrainer.code.d, atrainer.code.s, atrainer.code.m),
        "events": events, "switches": switches,
        "cached_schemes": atrainer.cached_schemes, "logs": logs}
    out["device"] = str(dev)
    return out


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` (default: the command line), run with the
    reference's lines printed, and return ``run``'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device, echo=print)


if __name__ == "__main__":
    main()
