"""`BenchResult`: the one record type every benchmark emits.

A result is a named bag of *finite* numeric metrics plus the context needed to
reproduce and compare them: the problem parameters, the captured environment,
the timing policy that produced any wall-clock numbers, and a `gates` map
declaring which metrics CI may regression-gate (and in which direction).

The schema is validated by hand (`validate_result`) rather than via a
jsonschema dependency; `SCHEMA` documents the exact shape of the serialized
dict.  `BENCH_<name>.json` files are written by `benchmarks/run.py` through
`write_results` and checked by `repro.bench.gate` in CI.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Any

SCHEMA_VERSION = 1

# Serialized shape of one result (documentation + the validator's source of
# truth).  `metrics` values must be finite numbers; `gates` keys must name
# metrics and map to a direction: "max" = bigger is better, "min" = smaller.
SCHEMA: dict[str, Any] = {
    "schema_version": int,
    "name": str,
    "metrics": {str: float},
    "params": dict,
    "env": dict,
    "timing": (dict, type(None)),
    "gates": {str: ("max", "min")},
    "extra": dict,
}


@dataclasses.dataclass(frozen=True)
class BenchResult:
    """One benchmark measurement with its reproduction context."""

    name: str
    metrics: dict[str, float]
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    env: dict[str, Any] = dataclasses.field(default_factory=dict)
    timing: dict[str, Any] | None = None
    gates: dict[str, str] = dataclasses.field(default_factory=dict)
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def validate(self) -> None:
        errors = validate_result(self.to_dict())
        if errors:
            raise ValueError(
                f"invalid BenchResult {self.name!r}: " + "; ".join(errors)
            )


def _is_finite_number(x: Any) -> bool:
    return (
        isinstance(x, (int, float))
        and not isinstance(x, bool)
        and math.isfinite(float(x))
    )


def validate_result(obj: Any) -> list[str]:
    """Return a list of schema violations (empty = valid)."""
    if not isinstance(obj, dict):
        return [f"result must be a dict, got {type(obj).__name__}"]
    errors: list[str] = []
    if obj.get("schema_version") != SCHEMA_VERSION:
        errors.append(
            f"schema_version must be {SCHEMA_VERSION}, "
            f"got {obj.get('schema_version')!r}"
        )
    name = obj.get("name")
    if not isinstance(name, str) or not name:
        errors.append("name must be a non-empty string")
    metrics = obj.get("metrics")
    if not isinstance(metrics, dict) or not metrics:
        errors.append("metrics must be a non-empty dict")
    else:
        for k, v in metrics.items():
            if not isinstance(k, str):
                errors.append(f"metric key {k!r} is not a string")
            if not _is_finite_number(v):
                errors.append(f"metric {k!r} must be a finite number, got {v!r}")
    for field in ("params", "env", "extra"):
        if not isinstance(obj.get(field), dict):
            errors.append(f"{field} must be a dict")
    timing = obj.get("timing")
    if timing is not None and not isinstance(timing, dict):
        errors.append("timing must be a dict or null")
    gates = obj.get("gates")
    if not isinstance(gates, dict):
        errors.append("gates must be a dict")
    elif isinstance(metrics, dict):
        for k, direction in gates.items():
            if direction not in ("max", "min"):
                errors.append(f"gate {k!r} direction must be 'max'|'min'")
            if k not in metrics:
                errors.append(f"gate {k!r} names no metric")
    return errors


def _sanitize(x: Any) -> Any:
    """Conversion to strict-JSON-native types: numpy scalars/arrays become
    lists/python scalars, non-finite floats become strings ("nan"/"inf") so
    the emitted files parse under any spec-compliant consumer (jq, JS)."""
    if hasattr(x, "tolist"):
        x = x.tolist()
    elif hasattr(x, "item"):
        x = x.item()
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)  # "nan" | "inf" | "-inf"
    if isinstance(x, dict):
        return {str(k): _sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sanitize(v) for v in x]
    return x


def write_results(
    results: list[BenchResult], bench: str, json_dir: str | pathlib.Path
) -> pathlib.Path:
    """Validate and write `BENCH_<bench>.json` into `json_dir`."""
    for r in results:
        r.validate()
    payload = {
        "schema_version": SCHEMA_VERSION,
        "bench": bench,
        "results": [_sanitize(r.to_dict()) for r in results],
    }
    out = pathlib.Path(json_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"BENCH_{bench}.json"
    path.write_text(
        json.dumps(payload, indent=2, sort_keys=True, allow_nan=False) + "\n"
    )
    return path


def load_results(path: str | pathlib.Path) -> list[dict[str, Any]]:
    """Read a `BENCH_*.json` file, validating every contained result."""
    payload = json.loads(pathlib.Path(path).read_text())
    if not isinstance(payload, dict) or "results" not in payload:
        raise ValueError(f"{path}: not a BENCH results file")
    results = payload["results"]
    for r in results:
        errors = validate_result(r)
        if errors:
            raise ValueError(f"{path}: invalid result: " + "; ".join(errors))
    return results
