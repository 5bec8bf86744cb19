"""The card a run measures: the check that it is there, and its record."""
from __future__ import annotations

import shutil
import subprocess


class NoCard(RuntimeError):
    """The run asked for more cards than the machine has."""


def require_cards(count: int) -> None:
    """Raise ``NoCard`` unless CUDA sees ``count`` cards or more.  There is
    no fallback to the CPU: a measurement without the card is no result."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: no card to measure")
    have = torch.cuda.device_count()
    if have < count:
        raise NoCard(f"the cell needs {count} cards, the machine has {have}")


def power_limit() -> str | None:
    """``nvidia-smi``'s power limit of card 0, as it prints it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader", "-i",
             "0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def record(count: int, peak_bytes: int) -> dict:
    """The result's ``device`` entry."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(count), "memory_peak_bytes": int(peak_bytes),
            "power_limit": power_limit()}
