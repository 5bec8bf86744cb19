"""Readings of the control and of planted faults at a cell's own size, the
upper readings that its limits are set below (they are not part of a run):

    python3 cellbench/control.py --workload <cell> --seeds 11,12,13

Nothing of the program runs.  The control is the plain reference put in the
program's place with every product's operands rounded to TF32 (the step
below float32 with TF32 off); a fault is planted in the reference's inputs.
Each is held against the float32 reference by the numbers a run compares,
and judged by the cell's limits as a run's numbers are: each row carries
``correct`` and the numbers it failed, which for the control and every
fault has to come out false.

The variants of a training cell: the control, and ``half_batch``, half of
every batch left out with the mean taken over the rest (the other half of
each subset's rows stand in for it; with one row a subset, half of the
subsets stand in for the others).  A step that leaves the state unchanged
reads 1 on the change's gap by definition and is not run.

Prints one JSON line a seed and variant, and a line of its verdict on
standard error.
"""
from __future__ import annotations

import argparse
import json
import sys

from run import ROOT, Context, _setup_env


def judged(ctx, row: dict, kind: str) -> dict:
    """``row`` with the cell's limits applied to the numbers it holds, as a
    run applies them: ``compared``, ``correct`` and ``failed_numbers``."""
    from harness.compare import Reading
    lim = ctx.config["limits"][kind]
    readings = [Reading(k, row[k], lim[k]) for k in lim if k in row]
    row["compared"] = {r.name: {"value": r.value, "limit": r.limit}
                       for r in readings}
    row["failed_numbers"] = [r.name for r in readings if not r.ok]
    row["correct"] = not row["failed_numbers"]
    return row


def half_batch(batch: dict, subsets: int) -> dict:
    """Half of ``batch`` left out, the mean over the rest: within each
    subset the second half of its rows repeats the first, or with one row
    a subset the second half of the subsets repeats the first."""
    out = {}
    for k, v in batch.items():
        v = v.clone()
        rows = v.shape[0] // subsets
        if rows > 1:
            w = v.view(subsets, rows, *v.shape[1:])
            w[:, rows // 2:2 * (rows // 2)] = w[:, :rows // 2]
        else:
            v[subsets // 2:2 * (subsets // 2)] = v[:subsets // 2]
        out[k] = v
    return out


def train_readings(ctx, seed: int) -> list[dict]:
    import numpy as np
    from harness import compare
    from reference.ops import Products
    ref = ctx.reference()
    steps = int(ctx.traffic["reference_steps"])

    def go(products, transform=None):
        losses, first, y0, last = ref.train_from_seed(
            ctx.config, seed, ctx.device, steps, products, transform)
        return losses, first, compare.norms(first), compare.norms(last, y0)

    b_losses, b_first, b_grad, b_change = go(Products())
    rows = []
    for name, products, transform in (("control", Products(tf32=True), None),
                                      ("half_batch", Products(), half_batch)):
        losses, first, g, ch = go(products, transform)
        gap, leaf, out = compare.norm_gap(g, b_grad)
        diffs = compare.diffs(first, b_first)
        dgap, dleaf, _ = compare.worst(diffs, b_grad)
        del first
        cgap, cleaf, _ = compare.norm_gap(ch, b_change)
        row = {"seed": seed, "variant": name,
               "loss_gap": float(np.max([compare.rel_gap(p, r) for p, r
                                         in zip(losses, b_losses)])),
               "grad_norm_gap": gap, "grad_leaf": leaf,
               "grad_diff": dgap, "grad_diff_leaf": dleaf,
               "grad_diffs": {k: v / b_grad[k] for k, v in diffs.items()},
               "change_norm_gap": cgap, "change_leaf": cleaf,
               "left_out": out, "losses": losses,
               "reference_losses": b_losses}
        rows.append(judged(ctx, row, "train"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    _setup_env()
    import torch
    from harness.device import require_cards
    from harness.manifest import load_cell, load_manifest
    cell = load_cell(load_manifest(ROOT), args.workload, ROOT)
    require_cards(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell, seed, 0.0, False, torch.device("cuda", 0))
        rows = train_readings(ctx, seed)
        for r in rows:
            print(json.dumps(r), flush=True)
            print(f"control {args.workload} seed {seed} {r['variant']}: "
                  f"correct={str(r['correct']).lower()} failed "
                  f"{r['failed_numbers']}", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
