"""`repro_torch.bench`: the benchmark harness of the port.

Structured, reproducible, regression-gated measurements, under the
reference's (`repro.bench`) names:

  result   — `BenchResult` + schema validation + `BENCH_*.json` I/O (a copy;
             files written by either package load under the other)
  timing   — deterministic warmup/rep wall-clock policy (`TimerPolicy`),
             synchronized on the card; the device timers (`time_ms`,
             `time_run_ms`, `host_us_per_call`, `profile_device`)
  env      — torch/CUDA/device/worker-group environment capture, with the
             card's name and power limit
  registry — discoverable `BenchSpec`s (a copy)
  straggler— Sec-VI shifted-exponential delay/dropout pattern injection (a
             copy)
  gate     — the regression gate against a baseline file
             (`python -m repro_torch.bench.gate`)

`result`, `registry`, `gate` and `straggler` are numpy only; `timing` and
`env` import torch.
"""

from .env import capture_env
from .registry import BenchSpec, all_specs, get_spec, names, register
from .result import (
    SCHEMA_VERSION,
    BenchResult,
    load_results,
    validate_result,
    write_results,
)
from .straggler import (
    StragglerPattern,
    draw_patterns,
    draw_patterns_hetero,
    draw_patterns_overlapped,
    mean_wait_s,
    overlap_fraction,
)
from .timing import TimerPolicy, TimingStats, time_callable, time_sequence

__all__ = [
    "SCHEMA_VERSION",
    "BenchResult",
    "BenchSpec",
    "StragglerPattern",
    "TimerPolicy",
    "TimingStats",
    "all_specs",
    "capture_env",
    "draw_patterns",
    "draw_patterns_hetero",
    "draw_patterns_overlapped",
    "get_spec",
    "load_results",
    "mean_wait_s",
    "names",
    "overlap_fraction",
    "register",
    "time_callable",
    "time_sequence",
    "validate_result",
    "write_results",
]
