"""The traced window: ``torch.profiler`` around it, reduced to what the
per-layer readers and the result's ``breakdown`` read.

Busy time is the union, over all streams, of the device's activities
(kernels, copies, fills) inside the window; an idle gap is a stretch of the
window in which none ran, named by the innermost operation the host was in
at the gap's middle.  The union is a frozen copy of the arithmetic of the
program's ``repro_torch.bench.timing._union_us``; the profiler's user
annotations, which it also lays over the device, are no operation.
"""
from __future__ import annotations

import bisect
import dataclasses
import re

MARK = "cellbench.window"


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones (the
    arithmetic of the program's ``_union_us``, kept as intervals so that
    the idle gaps between them can be named)."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class Trace:
    """What one traced window did on the device and on the host."""
    window_s: float                      # the window, by the profiler's clock
    busy_s: float                        # the union of device activity in it
    ops: list                            # (name, start_us, end_us) on the device
    gaps: dict                           # host operation -> idle seconds
    work: dict                           # what the driver says the window did
    counters: dict = dataclasses.field(default_factory=dict)

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name ``pattern`` finds
        (a regular expression, case-insensitive)."""
        rx = re.compile(pattern, re.I)
        return sum(b - a for n, a, b in self.ops if rx.search(n)) / 1e6

    def breakdown(self) -> dict:
        """The ten device operations that took most time and the ten host
        operations under the longest idle, each ``[name, seconds]``."""
        by_op: dict[str, float] = {}
        for n, a, b in self.ops:
            by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def _innermost(starts, cpu, t: float, reach: int = 400) -> str:
    """Name of the latest-starting host operation running at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        name, a, b = cpu[j]
        if b > t:
            return name
    return "host (no operation)"


def capture(window) -> tuple[Trace, object]:
    """Run ``window()`` under the profiler; return its ``Trace`` (``work``
    empty, for the driver to fill) and ``window()``'s result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            result = window()
            torch.cuda.synchronize()
    events = prof.events()
    mark = [e for e in events
            if e.name == MARK and e.device_type != DeviceType.CUDA]
    if not mark:
        raise RuntimeError("the profiler lost the window's own marker")
    w0, w1 = mark[0].time_range.start, mark[0].time_range.end
    window_s = (w1 - w0) / 1e6          # on the profiler's clock, as busy is
    ops, cpu = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name == MARK:
                # a range marked on the host (this window's, or a span of
                # the program's) that the profiler lays over the device
                # too: it is no operation, and no busy time
                continue
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ops.append((e.name, a, b))
        elif e.name != MARK and b > a:
            cpu.append((e.name, a, b))
    if not ops:
        raise RuntimeError("the profiler recorded no device activity in the "
                           "window")
    busy = merged((a, b) for _, a, b in ops)
    cpu.sort(key=lambda r: r[1])
    starts = [a for _, a, _ in cpu]
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = _innermost(starts, cpu, 0.5 * (a + b))
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6
    return Trace(window_s=window_s, busy_s=busy_s, ops=ops, gaps=gaps,
                 work={}), result
