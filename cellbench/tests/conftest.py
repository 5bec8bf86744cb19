"""Fixtures of the benchmark's CPU tests: the import paths run.py sets up,
and a checkout with tiny copies of the cells."""
from __future__ import annotations

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import tiny  # noqa: E402

tiny.import_paths()


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    """A checkout holding the tiny cells (read-only: copy it to change it)."""
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
