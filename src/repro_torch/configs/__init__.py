"""Config registry over what the port supports so far."""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "qwen3-1.7b": "qwen3_1p7b",
    "logistic-paper": "logistic_paper",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported so far: "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def list_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in _MODULES}


__all__ = ["ModelConfig", "get_config", "list_configs"]
