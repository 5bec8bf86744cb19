"""The port's doctests: every module of ``repro_torch`` with ``>>>`` lines
runs them with ``doctest.testmod``, one case a module, on one CPU thread.
The list is pinned against a search of the package's sources, so a module
that gains examples gains a case."""
import doctest
import importlib
import pathlib

import pytest
import torch

import repro_torch

torch.set_num_threads(1)

MODULES = ["coding.spec", "core.approx", "core.hetero", "core.schemes",
           "core.stable", "elastic.events", "tune.estimator",
           "tune.telemetry"]


def test_the_list_is_every_module_with_examples():
    root = pathlib.Path(repro_torch.__file__).parent
    found = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in root.rglob("*.py")
        if any(ln.strip().startswith(">>>")
               for ln in p.read_text().splitlines()))
    assert found == MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_doctests_pass(name):
    mod = importlib.import_module(f"repro_torch.{name}")
    res = doctest.testmod(mod, report=False)
    assert res.attempted > 0 and res.failed == 0, res
