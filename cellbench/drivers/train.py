"""Coded training (a traffic mix with ``"driver": "train"``).

Set-up builds one ``repro_torch.train.Trainer`` on the configuration's code
and optimizer, hands it the weights made from the seed, and drives it
through its first ``reference_steps`` steps on the seed's batches: those
steps warm up every shape the window uses, and the plain reference follows
them.  The window then drives the same trainer's ``step`` on the following
batches until ``--seconds`` have passed; each step's wall is the host's
clock around the call, which waits for the card (it reads the step's
metrics).  Each step's straggler set (0 to ``max_stragglers`` workers) is
drawn from the seed and the step's index.

The batches: a linear configuration trains on one batch of ``samples`` rows
every step (the paper's full-batch NAG on its data set); an LM
configuration draws ``batches`` batches of token sequences and walks them
in turn.

Compared with the reference, each number that the configuration gives a
limit: each of the first steps' loss (``loss_gap``); the first gradient as
the optimizer applied it, read back from its state after one step (NAG
keeps ``x_1 = y_0 - lr g``, so ``g = (y_0 - x_1) / lr``, the difference
taken in float64), by the worst leaf's gap between the program's norm and
the reference's (``grad_norm_gap``, ``harness.compare.norm_gap``), and,
where the configuration asks for it, by the worst leaf's norm of the
difference (``grad_diff``: the program's gradient is then kept on the host
until the reference has run); and the parameters' change over those
steps, by the norm gap (``change_norm_gap``).  The seconds these readings
take during set-up are the comparison's and are left out of ``setup_s``.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from harness import compare, inputs
from harness.host import HostProbe
from harness.port import port_config
from harness import trace as tracing
from harness.compare import Reading

COMPARED = ("loss_gap", "grad_norm_gap", "grad_diff", "change_norm_gap")


def weights(c: dict, seed: int, device) -> dict:
    """The starting weights: zeros for the linear model (the paper's
    starting point), the seed's draw for an LM."""
    if "features" in c:
        return {"beta": torch.zeros((c["features"],), dtype=torch.float32,
                                    device=device)}
    return inputs.lm_weights(c, seed, device)


def batches(c: dict, seed: int, device, rows: int):
    """``feed(i)``: step ``i``'s global batch of ``rows`` rows."""
    tc = c["train"]
    if "features" in c:
        one = inputs.logistic_rows(rows, c["features"], seed, device)
        return lambda i: one
    pool = inputs.token_batches(tc["batches"], rows, tc["seq_len"],
                                c["vocab_size"], seed, device)
    return lambda i: {k: v[i % tc["batches"]] for k, v in pool.items()}


def _leaf_count(c: dict) -> int:
    if "features" in c:
        return c["features"]
    return sum(math.prod(s) for _, s, _ in inputs.lm_leaves(c))


def run(ctx) -> dict:
    from repro_torch.coding import SchemeSpec
    from repro_torch.core import make_code
    from repro_torch.optim import nag
    from repro_torch.train import Trainer
    c, t, dev = ctx.config, ctx.traffic, ctx.device
    tc = c["train"]
    cfg = port_config(c)
    code = make_code(*c["code"])
    lr, first_steps = float(tc["lr"]), int(t["reference_steps"])
    rows = code.num_subsets * tc["rows_per_subset"]
    tr = Trainer(cfg, code, nag(lr), spec=SchemeSpec(),
                 straggler_source=inputs.SeededStragglers(
                     ctx.seed, tc["max_stragglers"]), device=dev)
    y0 = weights(c, ctx.seed, dev)
    have = {k: (tuple(v.shape), v.dtype) for k, v in tr.params.items()}
    if have != {k: (tuple(v.shape), v.dtype) for k, v in y0.items()}:
        raise ValueError("the program's parameters are not laid out as the "
                         "configuration's weights")
    tr.params = dict(y0)
    tr.opt_state = tr.optimizer.init(tr.params)
    gc.collect()
    feed = batches(c, ctx.seed, dev, rows)

    # the first steps: the warm-up, and what the reference follows
    keep_grad = "grad_diff" in c["limits"]["train"]
    losses, grad_norms, grad = [], None, None
    for i in range(first_steps):
        losses.append(tr.step(feed(i))["loss"])
        if i == 0:
            with ctx.apart():
                x1 = tr.opt_state["x_prev"]
                grad_norms = {k: compare.leaf_norm(y0[k], x1[k]) / lr
                              for k in y0}
                if keep_grad:
                    grad = compare.first_gradient(y0, x1, lr)
                del x1
    with ctx.apart():
        change_norms = compare.norms(tr.params, y0)
    del y0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.setup_done()

    state = {"i": first_steps, "failed": 0}

    def window(seconds, max_steps=None):
        walls = []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            m = tr.step(feed(state["i"]))
            walls.append(time.perf_counter() - a)
            state["i"] += 1
            state["failed"] += not math.isfinite(m["loss"])
            if (time.perf_counter() - t0 >= seconds
                    or (max_steps and len(walls) >= max_steps)):
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return walls, time.perf_counter() - t0

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"e2e": {}, "trace": None}
    if ctx.trace:
        before = sum(tr.arts.comm.bytes.values())
        trace, (walls, _) = tracing.capture(lambda: window(
            min(ctx.seconds, t["trace_max_seconds"]), t["trace_max_steps"]))
        trace.counters["comm_bytes"] = sum(tr.arts.comm.bytes.values()) - before
        trace.work = {"kind": "train", "model": c, "code": c["code"],
                      "steps": len(walls), "seq_len": tc.get("seq_len", 0),
                      "sequences_per_subset": tc["rows_per_subset"],
                      "params": _leaf_count(c)}
        out["trace"] = trace
    else:
        with HostProbe() as host:
            walls, span = window(ctx.seconds)
        ctx.note(step_walls_ms=[1e3 * float(q) for q in np.percentile(
            walls, [0, 25, 50, 75, 95, 100])], host=host.reading())
        out["e2e"] = {"train_step_ms": 1e3 * span / len(walls)}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out["e2e"]["peak_mem_gib"] = peak / 2**30
    out.update(peak_bytes=peak, attempted=len(walls), failed=state["failed"])

    # the program's state goes before the reference runs
    del tr, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["readings"] = readings(ctx, losses, grad_norms, change_norms, grad)
    return out


def readings(ctx, losses, grad_norms, change_norms, grad=None
             ) -> list[Reading]:
    """The compared numbers against the configuration's limits; ``grad``
    the program's first gradient, where ``grad_diff`` is compared."""
    from reference.ops import Products
    r_losses, r_first, r_y0, r_last = ctx.reference().train_from_seed(
        ctx.config, ctx.seed, ctx.device, int(ctx.traffic["reference_steps"]),
        Products())
    r_grad, r_change = compare.norms(r_first), compare.norms(r_last, r_y0)
    ctx.note(losses=losses, reference_losses=r_losses, grad_norms=grad_norms,
             reference_grad_norms=r_grad, change_norms=change_norms,
             reference_change_norms=r_change)
    lim = ctx.config["limits"]["train"]
    # numpy's max keeps a NaN, where Python's would drop it
    values = {"loss_gap": float(np.max([compare.rel_gap(p, r) for p, r
                                        in zip(losses, r_losses)])),
              "grad_norm_gap": compare.norm_gap(grad_norms, r_grad)[0],
              "change_norm_gap": compare.norm_gap(change_norms, r_change)[0]}
    if grad is not None:
        diffs = compare.diffs(grad, r_first)
        ctx.note(grad_diffs={k: v / r_grad[k] for k, v in diffs.items()})
        values["grad_diff"] = compare.worst(diffs, r_grad)[0]
    return [Reading(k, values[k], lim[k]) for k in COMPARED if k in lim]
