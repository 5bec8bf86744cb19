"""The import check, and what a run does where it must give no result."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness.guard import forbidden_modules
from harness.manifest import BENCH, ROOT


def test_whole_top_level_names_are_compared():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
             "repro.core.cyclic", "repro_torch", "repro_torch.core",
             "jaxtyping", "reproducible", "flaxen", "torch"]
    assert forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
         "repro.core.cyclic"])


def _run(args, cwd, **env):
    return subprocess.run([sys.executable, "cellbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **env))


ARGS = ["--workload", "olmoe-1b-7b.train-sync", "--seed", "3",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    r = _run(ARGS, ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no card" in r.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = _run(ARGS, tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_tiny_run_loads_no_jax(tiny_root):
    code = (
        "import sys, json, torch; sys.path[:0] = [%r, %r, %r]\n"
        "import tiny; tiny.import_paths()\n"
        "import run\n"
        "from harness.guard import forbidden_modules\n"
        "r = run.run_cell('tiny-moe.train-sync', 5, 0.1, False, "
        "device=torch.device('cpu'), root=__import__('pathlib').Path(%r))\n"
        "print(json.dumps([r['correct'], forbidden_modules()]))\n"
    ) % (str(BENCH / "tests"), str(BENCH), str(ROOT / "src"), str(tiny_root))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    correct, bad = json.loads(r.stdout.strip().splitlines()[-1])
    assert correct is True and bad == []


@pytest.mark.gpu
def test_each_tiny_cell_on_the_card(tiny_root):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import run
    for cell in ("tiny-logistic.train-sync", "tiny-moe.train-sync"):
        r = run.run_cell(cell, 7, 1.0, True, device=None, root=tiny_root)
        assert r["correct"] is True, r["compared"]
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        for name, m in r["metrics"].items():
            if m["unit"] == "%":
                assert 0 <= m["value"] <= 105, (cell, name, m)
