"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix.  The configuration's file is
the one ``configs[].file`` gives; the traffic mix is
``cellbench/traffic/<traffic>.json``, whose ``driver`` names
``cellbench/drivers/<driver>.py``; a per-layer metric ``<name>`` is read by
``cellbench/metrics/<name>.py``; a configuration's plain reference is
``cellbench/reference/<reference>.py``.  Adding any of them adds files and
manifest entries and edits nothing.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of the manifest with everything it names, loaded."""
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    end_to_end: list      # the manifest's end-to-end metrics this cell reports
    per_layer: list       # the manifest's per-layer metrics this cell reports


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    """The manifest at the root of the checkout."""
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_of_cell: set[str] | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_of_cell is None:            # an end-to-end metric with no list
        return True
    return metric["moves"] in e2e_of_cell


def cell_metrics(manifest: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics ``cell`` reports: an entry with
    ``workloads`` is reported in the cells it lists; an end-to-end metric
    without it in every cell; a per-layer metric without it in every cell
    that reports the end-to-end metric it moves."""
    e2e = [m for m in manifest["end_to_end"] if _reports(m, cell, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if _reports(m, cell, names)]
    return e2e, layer


def load_cell(manifest: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The workload ``name`` with its configuration, traffic and metrics."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"it has {sorted(by_name)}")
    w = by_name[name]
    cfgs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / cfgs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "cellbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e, layer = cell_metrics(manifest, name)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def load_module(kind: str, name: str, root: pathlib.Path = ROOT):
    """The module ``cellbench/<kind>/<name>.py`` (a name may hold dots and
    dashes, so it is loaded from its path)."""
    path = root / "cellbench" / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    mod_name = "cellbench_" + kind + "_" + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
