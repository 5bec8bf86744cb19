"""The host's readings beside a window, and the control's verdict by a
cell's limits."""
from __future__ import annotations

import gc
import types

import control
from harness.host import HostProbe


def test_the_host_probe_reads_the_window():
    with HostProbe() as probe:
        junk = [[i] for i in range(10000)]
        gc.collect()
    r = probe.reading()
    del junk
    assert r["wall_s"] > 0 and r["process_cpu_s"] >= 0
    assert r["gc"]["collections"][2] >= 1 and r["gc"]["longest_s"] > 0
    assert probe._on_gc not in gc.callbacks


def test_control_rows_are_judged_by_the_cells_limits():
    ctx = types.SimpleNamespace(
        config={"limits": {"train": {"loss_gap": 1e-4, "grad_diff": 7e-5}}})
    row = control.judged(ctx, {"loss_gap": 5e-5, "grad_diff": 2e-4,
                               "change_norm_gap": 9.0}, "train")
    assert row["correct"] is False and row["failed_numbers"] == ["grad_diff"]
    assert row["compared"] == {"loss_gap": {"value": 5e-5, "limit": 1e-4},
                               "grad_diff": {"value": 2e-4, "limit": 7e-5}}
    ok = control.judged(ctx, {"loss_gap": 1e-4, "grad_diff": 7e-5}, "train")
    assert ok["correct"] is True and ok["failed_numbers"] == []
