"""Run one cell of the benchmark of the PyTorch and CUDA port (``repro_torch``)
on the card of this machine, and print its result as one JSON line.

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names a
configuration and a traffic mix; the mix's ``driver`` (``cellbench/drivers/``)
builds the program's entry from inputs made from ``--seed``, warms up every
shape it will use, and drives the entry for ``--seconds`` seconds.  With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` a profiled window and the per-layer metrics that
``cellbench/metrics/<name>.py`` read from it.  Either way the program's
output is then held against the plain reference (``cellbench/reference/``),
which decides ``correct``; the numbers compared are the last lines on
standard error and the last key of the result.

Exit codes: 0 a result was printed; 1 the run failed; 3 the machine lacks
the cards the cell needs; 4 a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def process_seconds() -> float:
    """Seconds since this process started, from the kernel's record of its
    start; the clock at this module's import where that is unreadable."""
    try:
        stat = pathlib.Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def _setup_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    libraries that would load JAX by themselves told not to; one thread
    for the host's numerical libraries (the host's work a step is small
    and serial, and idle threads of a pool only add jitter)."""
    cache = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    for p in (str(ROOT / "src"), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


class Context:
    """What a driver is given, and how it says that set-up is over."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.setup_s: float | None = None
        self._apart = 0.0

    @contextlib.contextmanager
    def apart(self):
        """Work done inside is the comparison's, not the program's set-up
        (readings kept for the reference): its seconds are left out of
        ``setup_s``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._apart += time.perf_counter() - t0

    def setup_done(self) -> None:
        """Set-up ends here: the next thing the driver does is timed."""
        self.setup_s = process_seconds() - self._apart

    def note(self, **kw) -> None:
        """A line of detail on standard error, before the compared numbers."""
        print("cellbench-note " + json.dumps(kw, default=str), file=sys.stderr)

    def reference(self):
        """The configuration's plain reference module."""
        import importlib
        return importlib.import_module(f"reference.{self.config['reference']}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, root: pathlib.Path = ROOT) -> dict:
    """Run a cell and return its result (not printed).  ``device`` is the
    card unless a test hands another; ``root`` the checkout whose manifest
    and files are read."""
    import torch
    from harness import device as card
    from harness.manifest import load_cell, load_manifest, load_module
    cell = load_cell(load_manifest(root), workload, root)
    build = None
    if device is None:
        card.require_cards(cell.chips)
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from harness.port import load_kernels
        build = load_kernels()
    ctx = Context(cell, seed, seconds, trace, device)
    driver = load_module("drivers", cell.traffic["driver"], root)
    out = driver.run(ctx)
    gc.collect()
    metrics = {}
    if trace:
        tr = out["trace"]
        for m in cell.per_layer:
            value = load_module("metrics", m["name"], root).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    readings = out["readings"]
    result = {"correct": all(r.ok for r in readings),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics}
    if device.type == "cuda":
        result["device"] = card.record(cell.chips, out["peak_bytes"])
    else:
        result["device"] = {"platform": device.type, "count": 1,
                            "memory_peak_bytes": out["peak_bytes"]}
    if build is not None:
        # within setup_s: the first run in a checkout builds the kernels
        result["setup_parts"] = build
    if trace:
        result["device"].update(busy_s=out["trace"].busy_s,
                                window_s=out["trace"].window_s)
        result["breakdown"] = out["trace"].breakdown()
    result["compared"] = {r.name: {"value": r.value, "limit": r.limit}
                          for r in readings}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_env()
    from harness.device import NoCard
    from harness.guard import forbidden_modules
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoCard as e:
        print(f"cellbench: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"cellbench: modules of JAX or of the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    for name, r in result["compared"].items():
        print(f"compared {name} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
