"""Environment capture for benchmark records.

Everything that makes two measurements comparable (or not): interpreter and
library versions, the device and its inventory, whether f32 matmuls may
round through TF32 (every path of the port is held to f32 without it), the
card's name and power limit (a card set below its maximum runs slower under
load), and the worker group.  Keys are stable so JSON diffs stay readable.
"""

from __future__ import annotations

import platform
import subprocess
from typing import Any

import numpy
import torch

from .._device import resolve_device


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them for
    the first card; raises ``RuntimeError`` if ``nvidia-smi`` fails."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"nvidia-smi: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def capture_env(device: str | torch.device = "cuda",
                comm: Any | None = None) -> dict[str, Any]:
    """Snapshot the software/hardware context of a benchmark run on
    ``device`` (the card by default; raises without one, as every entry
    point does).  ``comm``, a worker group of ``repro_torch.comm``, adds
    its workers, ranks and backend (``"local"`` for one process)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    env: dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.system().lower(),
        "numpy": numpy.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": dev.type,
        "device_count": torch.cuda.device_count() if cuda else 1,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    if cuda:
        env["nvidia_smi"] = nvidia_smi_line()
    if comm is not None:
        env["comm"] = {"workers": comm.n,
                       "ranks": getattr(comm, "world_size", 1),
                       "comm_backend": getattr(comm, "backend", "local")}
    return env
