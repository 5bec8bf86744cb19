"""CI regression gate over `BENCH_*.json` results.

Compares every gated metric (declared in each result's `gates` map) against a
committed baseline and fails when a metric *worsens* by more than the
tolerance in its declared direction:

    direction "max": fail when value < baseline * (1 - tol)
    direction "min": fail when value > baseline * (1 + tol)

Baseline format (a JSON file named by `--baseline`):

    {"schema_version": 1,
     "tolerance": 0.2,
     "benches": {"<result name>": {"<metric>": <value>, ...}, ...}}

Raw wall-clock metrics are deliberately *not* gated by the benchmarks (CI
hardware varies by far more than any real regression); the gated metrics are
scale-free model/correctness quantities (speedup ratios, reproduction checks,
error bounds).  Regenerate the baseline after an intentional change with:

    PYTHONPATH=src python -m repro_torch.bench.gate --results DIR \
        --baseline FILE --update
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from .result import SCHEMA_VERSION, load_results

DEFAULT_TOLERANCE = 0.2


def collect_gated(results_dir: str | pathlib.Path):
    """{result name: {metric: (value, direction)}} across BENCH_*.json files."""
    out: dict[str, dict[str, tuple[float, str]]] = {}
    files = sorted(pathlib.Path(results_dir).glob("BENCH_*.json"))
    if not files:
        raise FileNotFoundError(f"no BENCH_*.json files in {results_dir}")
    for f in files:
        for r in load_results(f):
            gated = {
                metric: (float(r["metrics"][metric]), direction)
                for metric, direction in r["gates"].items()
            }
            if gated:
                if r["name"] in out:
                    raise ValueError(
                        f"duplicate gated result name {r['name']!r} in {f} — "
                        f"result names must be unique across benches"
                    )
                out[r["name"]] = gated
    return out


def _worsened(value: float, base: float, direction: str, tol: float) -> bool:
    span = abs(base) * tol
    if direction == "max":
        return value < base - span
    return value > base + span


def check(observed, baseline: dict, tolerance: float | None = None) -> list[str]:
    """Return a list of regression messages (empty = gate passes)."""
    tol = (
        tolerance
        if tolerance is not None
        else float(baseline.get("tolerance", DEFAULT_TOLERANCE))
    )
    failures = []
    benches = baseline.get("benches", {})
    for name, base_metrics in benches.items():
        if name not in observed:
            failures.append(f"{name}: gated result missing from this run")
            continue
        for metric, base in base_metrics.items():
            if metric not in observed[name]:
                failures.append(f"{name}.{metric}: gated metric disappeared")
                continue
            value, direction = observed[name][metric]
            if _worsened(value, float(base), direction, tol):
                failures.append(
                    f"{name}.{metric}: {value:.6g} regressed vs baseline "
                    f"{float(base):.6g} (direction={direction}, tol={tol:.0%})"
                )
    # a gated metric with no baseline entry would otherwise silently never
    # protect anything — adding a gate requires regenerating the baseline
    for name, gated in observed.items():
        for metric in gated:
            if metric not in benches.get(name, {}):
                failures.append(
                    f"{name}.{metric}: gated metric has no baseline entry — "
                    f"regenerate with --update"
                )
    return failures


def write_baseline(observed, path, tolerance: float = DEFAULT_TOLERANCE) -> None:
    payload = {
        "schema_version": SCHEMA_VERSION,
        "tolerance": tolerance,
        "benches": {
            name: {m: v for m, (v, _) in sorted(observed[name].items())}
            for name in sorted(observed)
        },
    }
    pathlib.Path(path).write_text(
        json.dumps(payload, indent=2, sort_keys=True) + "\n"
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", required=True, help="dir of BENCH_*.json files")
    ap.add_argument("--baseline", required=True, help="baseline.json path")
    ap.add_argument("--tolerance", type=float, default=None)
    ap.add_argument(
        "--update",
        action="store_true",
        help="rewrite the baseline from this run instead of gating",
    )
    args = ap.parse_args(argv)
    observed = collect_gated(args.results)
    baseline_path = pathlib.Path(args.baseline)
    if args.update:
        tol = args.tolerance
        if tol is None and baseline_path.exists():
            # preserve a customized tolerance across value refreshes
            tol = json.loads(baseline_path.read_text()).get("tolerance")
        if tol is None:
            tol = DEFAULT_TOLERANCE
        write_baseline(observed, args.baseline, tol)
        print(f"baseline updated: {args.baseline} ({len(observed)} results, "
              f"tolerance {tol:.0%})")
        return 0
    if not baseline_path.exists():
        print(f"gate: baseline {baseline_path} missing — run with --update first")
        return 1
    baseline = json.loads(baseline_path.read_text())
    failures = check(observed, baseline, args.tolerance)
    for name in sorted(observed):
        known = name in baseline.get("benches", {})
        print(
            f"gate: {name}: {len(observed[name])} gated metric(s)"
            + ("" if known else " [not in baseline]")
        )
    if failures:
        print("\n".join("REGRESSION " + f for f in failures), file=sys.stderr)
        return 1
    print("gate: no regressions")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
