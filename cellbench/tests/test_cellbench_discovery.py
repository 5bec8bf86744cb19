"""A cell, a configuration, a traffic mix and a per-layer metric are added
as new files and manifest entries, and the harness finds them with no
other file edited."""
from __future__ import annotations

import hashlib
import json
import shutil

import run
from harness import manifest as mf
from harness.trace import Trace


def _digests(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_only(tiny_root, tmp_path, cpu):
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    bench = root / "cellbench"
    # a configuration: the tiny logistic model with more rows a subset
    cfg = json.loads((bench / "configs" / "tiny-logistic.json").read_text())
    cfg.update(name="tiny-logistic-wide")
    cfg["train"] = dict(cfg["train"], rows_per_subset=6)
    (bench / "configs" / "tiny-logistic-wide.json").write_text(json.dumps(cfg))
    # a traffic mix: data only, read by the existing driver
    mix = json.loads((bench / "traffic" / "train-sync.json").read_text())
    mix.update(reference_steps=2, why="two reference steps")
    (bench / "traffic" / "train-sync-2.json").write_text(json.dumps(mix))
    # a per-layer metric: a reader of its own
    (bench / "metrics" / "steps_traced.train.py").write_text(
        "def read(trace):\n    return float(trace.work['steps'])\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-logistic-wide", "source": cfg["source"],
                         "file": "cellbench/configs/tiny-logistic-wide.json",
                         "reduced": cfg["reduced"], "why": "a new config"})
    m["workloads"].append({"name": "tiny-logistic-wide.train-sync-2",
                           "config": "tiny-logistic-wide",
                           "traffic": "train-sync-2", "chips": 1,
                           "why": "a new cell"})
    for e in m["end_to_end"]:
        if e["name"] == "train_step_ms":
            e["workloads"].append("tiny-logistic-wide.train-sync-2")
    m["per_layer"].append({"name": "steps_traced.train", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "train_step_ms",
                           "workloads": ["tiny-logistic-wide.train-sync-2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    cell = mf.load_cell(mf.load_manifest(root), "tiny-logistic-wide.train-sync-2",
                        root)
    assert cell.traffic["reference_steps"] == 2
    assert [x["name"] for x in cell.per_layer] == ["steps_traced.train"]
    reader = mf.load_module("metrics", "steps_traced.train", root)
    fake = Trace(window_s=1.0, busy_s=0.5, ops=[], gaps={}, work={"steps": 3})
    assert reader.read(fake) == 3.0
    r = run.run_cell("tiny-logistic-wide.train-sync-2", 8, 0.2, False,
                     device=cpu, root=root)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"train_step_ms", "peak_mem_gib", "setup_s"}

    after = _digests(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {root.joinpath("BENCHMARK.json").relative_to(root)}
