"""Section V reproduction on the PyTorch/CUDA port: logistic regression with
NAG under the three schemes (naive / m=1 coded / this paper's m>1 coded),
reporting generalization AUC vs simulated wall-clock (Fig. 4 analogue).

The twin of ``examples/logistic_amazon.py``, with its flags, defaults,
data, schemes, optimizer, runtime model and printed lines.  It differs in:

- the device: the ``n`` workers are the port's single-process worker group
  on one device (``Trainer(cfg, code, optimizer, device=...)`` over
  ``LocalComm``), the card by default; ``--device cpu`` runs the plain
  PyTorch versions on the host.  There is no host-device mesh and no
  ``XLA_FLAGS`` preamble, and no quiet fall-back to the host.
- ``run(backend=)`` (the reference has no such flag and runs its default,
  ``auto``): the port's names, ``auto`` (the kernels on the card, the
  plain versions on the host), ``ref`` or ``hopper``.
- ``auc_score``: its own copy (the reference imports it from
  ``benchmarks/``, which the port does not import).
- the training batch is placed on the device once and reused every step
  (the reference hands the host arrays to every step; the numbers are
  the same).
- ``--out`` defaults to ``results/logistic_amazon_torch.json``, in the
  reference's schema (``{scheme: {"auc": [...], "cum_time": [...]}}``).

``run()`` is the library form: it returns what the script prints and, per
scheme, the measured milliseconds of each step (to a device sync), the
kernel launches by kernel and kernel path, and the final ``beta``.

The Kaggle Amazon Employee Access dataset is unavailable offline; a
synthetic sparse-binary proxy with matched shape characteristics stands in
(``repro_torch.data.synthetic_logistic_dataset``).  Per-iteration times come
from the Section-VI shifted-exponential model, calibrated to the
comm-heavy EC2 regime.  The learning part (coded gradient aggregation with
NAG) runs for real, with random stragglers killed every step.

  PYTHONPATH=src python examples/logistic_amazon_torch.py --iters 40
  PYTHONPATH=src python examples/logistic_amazon_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import coding, resolve_device
from repro_torch.configs import get_config
from repro_torch.core import make_code
from repro_torch.core.runtime_model import (RuntimeParams, optimal_triple,
                                            simulate_runtimes)
from repro_torch.data import synthetic_logistic_dataset
from repro_torch.kernels import ops
from repro_torch.optim import get_optimizer
from repro_torch.train import Trainer
from repro_torch.tune import NoStragglers, RandomStragglers


def auc_score(y: np.ndarray, score: np.ndarray) -> float:
    """Mann-Whitney AUC (ties handled by average rank)."""
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(score) + 1)
    # average ranks for ties
    s_sorted = score[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = ranks[order[i:j + 1]].mean()
        i = j + 1
    pos = y == 1
    n1, n0 = pos.sum(), (~pos).sum()
    if n1 == 0 or n0 == 0:
        return 0.5
    return (ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0)


def _delta(before: dict, after: dict) -> dict:
    """Counts in ``after`` beyond ``before``, nested one level or flat."""
    return {k: (_delta(before[k], v) if isinstance(v, dict)
                else v - before[k]) for k, v in after.items()}


def run(*, iters: int = 40, dim: int = 1024, samples: int = 8192, n: int = 8,
        lr: float = 2.0, device: str | torch.device = "cuda",
        backend: str = "auto", out: str | None = None, data=None,
        keep_betas: bool = False, echo=None) -> dict:
    """Train the three schemes on the proxy dataset and return what the
    example prints: ``triples`` (``m1`` and ``ours``: the optimal (d, s, m)
    without and with ``m > 1``), ``results`` (the reference's JSON: each
    scheme's AUC and simulated cumulative time by iteration), ``target``
    and ``time_to_target`` (NaN where it is not reached), and by scheme in
    ``schemes``: ``code`` (n, d, s, m), ``describe``, ``coded_fraction``
    (the share of the gradient that is coded: 0 where m does not divide
    ``dim``), ``step_ms`` (each step to a device sync),
    ``launches`` / ``paths`` (its kernel launches by kernel and by kernel
    path), ``beta`` (final, float32) and, with ``keep_betas``, ``betas``
    (``(iters, dim)``, each iteration's).  ``data`` is ``(X, y)`` as
    ``synthetic_logistic_dataset`` returns them (drawn from seed 0 when
    None); ``out`` the JSON path to write (none when None); ``echo`` (e.g.
    ``print``) gets the reference's lines as they come."""
    say = echo or (lambda *_: None)
    dev = resolve_device(device)
    X, y = data if data is not None else synthetic_logistic_dataset(
        samples, dim, seed=0)[:2]
    samples, dim = X.shape
    ntr = int(samples * 0.75)
    Xtr, ytr, Xte, yte = X[:ntr], y[:ntr], X[ntr:], y[ntr:]
    # the reference's ``Xte @ beta`` casts Xte to float64 every iteration
    Xte64 = Xte.astype(np.float64)

    cfg = dataclasses.replace(get_config("logistic-paper"), d_model=dim)
    params_rt = RuntimeParams(n=n, lambda1=0.5, lambda2=0.2, t1=0.5, t2=16.0)
    (d1, s1, m1), _ = optimal_triple(params_rt, npts=30_000, restrict_m1=True)
    (d2, s2, m2), _ = optimal_triple(params_rt, npts=30_000)
    schemes = {
        "naive": dict(code=make_code(n, 1, 0, 1), schedule="psum",
                      strag="none"),
        f"m1_d{d1}": dict(code=make_code(n, d1, s1, m1),
                          schedule="gather", strag="random"),
        f"ours_d{d2}m{m2}": dict(code=make_code(n, d2, s2, m2),
                                 schedule="gather", strag="random"),
    }

    gb = ntr - ntr % n
    batch = {"x": torch.as_tensor(Xtr[:gb].astype(np.float32)).to(dev),
             "y": torch.as_tensor(ytr[:gb]).to(dev)}
    results, report = {}, {}
    for name, sc in schemes.items():
        source = (RandomStragglers(seed=1) if sc["strag"] == "random"
                  else NoStragglers())
        tr = Trainer(cfg, sc["code"], get_optimizer("nag", lr / gb),
                     spec=coding.SchemeSpec(schedule=sc["schedule"],
                                            backend=backend),
                     straggler_source=source, device=dev)
        launches0, paths0 = ops.launch_counts(), ops.path_counts()
        aucs, step_ms, betas = [], [], []
        for _ in range(iters):
            t0 = time.perf_counter()
            tr.step(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            beta = tr.params["beta"].detach().cpu().numpy().copy()
            if keep_betas:
                betas.append(beta)
            aucs.append(float(auc_score(yte, Xte64 @ beta.astype(np.float64))))
        c = sc["code"]
        times = simulate_runtimes(params_rt, c.d, c.s, c.m, iters, seed=1)
        if name == "naive":  # waits for all n workers
            rng = np.random.default_rng(1)
            times = (params_rt.t1 + rng.exponential(1 / params_rt.lambda1,
                                                    (iters, n))
                     + params_rt.t2 + rng.exponential(1 / params_rt.lambda2,
                                                      (iters, n))
                     ).max(axis=1)
        results[name] = {"auc": aucs, "cum_time": np.cumsum(times).tolist()}
        report[name] = {
            "code": (c.n, c.d, c.s, c.m), "describe": c.describe(),
            "coded_fraction": tr.arts.coded_fraction, "step_ms": step_ms,
            "launches": _delta(launches0, ops.launch_counts()),
            "paths": _delta(paths0, ops.path_counts()), "beta": beta}
        if keep_betas:
            report[name]["betas"] = np.stack(betas)
        say(f"{name:12s} final AUC {aucs[-1]:.4f}  "
            f"sim time {results[name]['cum_time'][-1]:.0f}s  ({c.describe()})")

    target = 0.5 * (results["naive"]["auc"][0] + max(results["naive"]["auc"]))
    say(f"\ntime to reach AUC >= {target:.4f}:")
    to_target = {}
    for name, r in results.items():
        auc = np.array(r["auc"])
        k = int(np.argmax(auc >= target)) if (auc >= target).any() else -1
        to_target[name] = r["cum_time"][k] if k >= 0 else float("nan")
        say(f"  {name:12s} {to_target[name]:8.1f}s")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f)
    return {"triples": {"m1": (d1, s1, m1), "ours": (d2, s2, m2)},
            "results": results, "target": target,
            "time_to_target": to_target, "schemes": report,
            "device": str(dev)}


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` (default: the command line), run with the
    reference's lines printed, and return ``run``'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=8192)
    ap.add_argument("--n", type=int, default=8, help="workers (data axis)")
    ap.add_argument("--lr", type=float, default=2.0)
    ap.add_argument("--out", default="results/logistic_amazon_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(iters=args.iters, dim=args.dim, samples=args.samples,
               n=args.n, lr=args.lr, device=args.device, out=args.out,
               echo=print)


if __name__ == "__main__":
    main()
