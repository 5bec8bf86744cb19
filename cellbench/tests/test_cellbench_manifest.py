"""The manifest keeps the benchmark's contract: its keys, names, units,
limits and budget, and every file it names is there."""
from __future__ import annotations

import json
import math
import re

import pytest

from harness import manifest as mf

ROOT = mf.ROOT
M = mf.load_manifest(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert M["paths"] == ["cellbench"]
    assert 1 <= len(M["command"]) <= 32
    assert all(TEXT.match(w) for w in M["command"])
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])


def test_entries_have_only_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}


def test_names_units_and_texts():
    names = ([c["name"] for c in M["configs"]] + CELLS
             + [m["name"] for m in M["end_to_end"] + M["per_layer"]]
             + [w["traffic"] for w in M["workloads"]]
             + [k for c in M["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in (M["configs"], M["workloads"],
                  M["end_to_end"] + M["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in M["configs"] + M["workloads"]:
        assert TEXT.match(x["why"])
    assert all(TEXT.match(c["source"]) for c in M["configs"])
    assert all(TEXT.match(m["layer"]) for m in M["per_layer"])


def test_end_to_end_metrics_and_bounds():
    names = [m["name"] for m in M["end_to_end"]]
    allowed = ["train_step_ms", "peak_mem_gib", "setup_s"]
    assert names == [n for n in allowed if n in names]
    assert {"peak_mem_gib", "setup_s"} <= set(names)
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in M["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_and_a_layer(cell):
    e2e, layer = mf.cell_metrics(M, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names, (cell, m["name"])


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS), m["name"]
    layers = {m["layer"] for m in M["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, f"layer {layer!r} is not in PERF.md"


@pytest.mark.parametrize("cell", CELLS)
def test_every_named_file_is_there(cell):
    c = mf.load_cell(M, cell, ROOT)
    assert (ROOT / "cellbench" / "drivers"
            / f"{c.traffic['driver']}.py").exists()
    assert (ROOT / "cellbench" / "reference"
            / f"{c.config['reference']}.py").exists()
    for m in c.per_layer:
        assert (ROOT / "cellbench" / "metrics" / f"{m['name']}.py").exists()
    assert set(c.config["limits"]) >= {c.traffic["driver"]}


def test_configs_are_used_and_their_files_distinct():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert c["file"].startswith("cellbench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        widths = [k for k in c["reduced"] if k.endswith(("_dim", "_rank",
                                                          "_size"))]
        assert not widths


def test_chips_and_budget():
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, math.floor(0.25 * len(CELLS)))
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
