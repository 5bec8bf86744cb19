"""A checkout of the benchmark with tiny configurations, for the CPU tests:
the real ``cellbench/`` copied, and beside its files small versions of each
configuration and traffic mix, with a manifest of cells over them."""
from __future__ import annotations

import copy
import json
import pathlib
import shutil
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

LM = {"hidden_size": 64, "intermediate_size": 32, "num_attention_heads": 4,
      "num_key_value_heads": 4, "head_dim": 16, "num_hidden_layers": 2,
      "num_experts": 8, "num_experts_per_tok": 2, "vocab_size": 128}
PORT_LM = {"d_model": 64, "d_ff": 32, "n_heads": 4, "n_kv_heads": 4,
           "head_dim": 16, "n_layers": 2, "n_experts": 8, "top_k": 2,
           "vocab": 128}
SEQ = 24

CELLS = {"tiny-logistic.train-sync": ("tiny-logistic", "train-sync"),
         "tiny-moe.train-sync": ("tiny-moe-l2", "train-sync")}


def import_paths() -> None:
    """The program and the benchmark's modules importable, as run.py makes
    them."""
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def configs() -> dict[str, dict]:
    """The tiny configurations, each the real one with small sizes."""
    def load(name):
        return json.loads((BENCH / "configs" / f"{name}.json").read_text())
    log = load("logistic-paper")
    log.update(name="tiny-logistic", features=64,
               port={"config": "logistic-paper", "overrides": {"d_model": 64}})
    log["train"] = dict(log["train"], rows_per_subset=4, lr=1e-3)
    moe_l2 = load("olmoe-1b-7b-l4")
    moe_l2.update(LM, name="tiny-moe-l2",
                  port={"config": "olmoe-1b-7b", "overrides": dict(PORT_LM)})
    moe_l2["train"] = dict(moe_l2["train"], seq_len=SEQ, batches=4)
    return {c["name"]: c for c in (log, moe_l2)}


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout under ``tmp`` holding the tiny cells; returns its root."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfgs = configs()
    manifest["configs"] = []
    for name, c in cfgs.items():
        path = f"cellbench/configs/{name}.json"
        (root / path).write_text(json.dumps(c, indent=1))
        manifest["configs"].append({"name": name, "source": c["source"],
                                    "file": path, "reduced": c["reduced"],
                                    "why": "a tiny copy for the CPU tests"})
    # the cell whose metrics each tiny cell reports (the logistic cell is
    # out of the manifest; it reports what the training cell does)
    like = {"tiny-logistic.train-sync": "olmoe-1b-7b.train-sync",
            "tiny-moe.train-sync": "olmoe-1b-7b.train-sync"}
    manifest["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1,
         "why": f"a tiny copy of {c}.{t}"} for n, (c, t) in CELLS.items()]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, r in like.items() if r in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root


def tiny_manifest_copy(root: pathlib.Path) -> dict:
    """The tiny checkout's manifest, to be changed and written back."""
    return copy.deepcopy(json.loads((root / "BENCHMARK.json").read_text()))
