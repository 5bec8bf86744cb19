"""Config registry over what the port supports so far."""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "qwen2-72b": "qwen2_72b",
    "qwen3-8b": "qwen3_8b",
    "qwen3-1.7b": "qwen3_1p7b",
    "granite-34b": "granite_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "grok-1-314b": "grok_1_314b",
    "internvl2-26b": "internvl2_26b",
    "xlstm-350m": "xlstm_350m",
    "zamba2-1.2b": "zamba2_1p2b",
    "whisper-tiny": "whisper_tiny",
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
