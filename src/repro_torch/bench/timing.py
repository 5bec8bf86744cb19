"""Deterministic timing on the card.

The reference's wall-clock API, on the port's device: policy is explicit
and fixed (no adaptive rep counts): `warmup` untimed calls (kernel builds +
cache effects), then `reps` timed calls, each synchronized so that the
card's work is actually on the clock.  The same policy object is recorded
into `BenchResult.timing` so two JSON files are comparable at a glance.

Beside it, the device timers of the port's smoke run: ``time_ms`` (CUDA
events around one call), ``time_run_ms`` (one event pair over a run of
back-to-back calls), ``host_us_per_call`` (the host's cost of a call) and
``profile_device`` (``torch.profiler``'s device-busy union over streams).
These need the card.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

RUN_LAUNCHES = 64              # back-to-back launches of one timed run
HOST_CALLS = 200               # calls of one host-cost measurement


@dataclasses.dataclass(frozen=True)
class TimerPolicy:
    """Fixed warmup/repetition policy (deterministic across runs)."""

    warmup: int = 1
    reps: int = 10


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Per-call wall-clock statistics in seconds."""

    mean_s: float
    min_s: float
    max_s: float
    std_s: float
    reps: int
    warmup: int

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _sync(out: Any) -> None:
    """Wait for the card's work: the current CUDA device and the device of
    every CUDA tensor in ``out`` (a tensor, or a tuple, list or dict of
    them).  A call that works in place and returns ``None`` has queued its
    kernels on the current device, so that one is always waited for.  Where
    CUDA was never initialised (a CPU-only box, or a run on the CPU) there
    is nothing to wait for, and nothing is touched."""
    if not torch.cuda.is_initialized():
        return
    devices = {torch.cuda.current_device()}
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device.index)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    for d in sorted(devices):
        torch.cuda.synchronize(d)


def time_callable(
    fn: Callable[..., Any],
    *args: Any,
    policy: TimerPolicy = TimerPolicy(),
    sync: Callable[[Any], None] = _sync,
) -> TimingStats:
    """Time `fn(*args)` under `policy`, synchronizing each call via `sync`."""
    for _ in range(policy.warmup):
        sync(fn(*args))
    samples = []
    for _ in range(policy.reps):
        t0 = time.perf_counter()
        sync(fn(*args))
        samples.append(time.perf_counter() - t0)
    return TimingStats(
        mean_s=statistics.fmean(samples),
        min_s=min(samples),
        max_s=max(samples),
        std_s=statistics.pstdev(samples) if len(samples) > 1 else 0.0,
        reps=policy.reps,
        warmup=policy.warmup,
    )


def time_sequence(
    fns: list[Callable[[], Any]],
    *,
    warmup: Callable[[], Any] | None = None,
    sync: Callable[[Any], None] = _sync,
) -> list[float]:
    """Time a heterogeneous sequence of thunks (one sample each).

    Used by the straggler bench where every iteration runs with a *different*
    input pattern: `warmup` (typically the first pattern) is called untimed to
    absorb the first call's costs, then each thunk is timed once.
    """
    if warmup is not None:
        sync(warmup())
    out = []
    for fn in fns:
        t0 = time.perf_counter()
        sync(fn())
        out.append(time.perf_counter() - t0)
    return out


def time_ms(fn, reps=25, warmup=5):
    """Median device time of one call ``fn(i)``: CUDA events around the
    call, queued behind a spin kernel so the host's enqueue cost is not in
    the span.  ``i`` counts the calls, so the caller can hand each call
    another copy of its inputs."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(warmup + len(times))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_run_ms(fn, launches=RUN_LAUNCHES, reps=5, warmup=3):
    """Median device time per call over a run of ``launches`` back-to-back
    calls ``fn(i)`` between one pair of CUDA events.  The run is queued
    behind a spin kernel; if the device reached the run's start before the
    host had queued all of it (host gaps inside the span), the spin is
    doubled and the run taken again.  ``i`` keeps counting across runs, so
    rotating operands never repeat within a cache's reach."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    spin, i, times = 4_000_000, warmup, []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(launches):
            fn(i)
            i += 1
        end.record()
        covered = not start.query()
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end) / launches)
        elif spin > 1 << 32:
            raise RuntimeError(
                "the host could not queue a run of launches ahead of the card")
        else:
            spin *= 2
    return statistics.median(times)


def host_us_per_call(fn, calls=HOST_CALLS, reps=5):
    """Host microseconds per call of ``fn()``: the host clock over
    ``calls`` calls with no sync between them, then one sync outside the
    span (the device's time is not in it unless the launch queue fills);
    median of ``reps`` such spans, as the host is shared."""
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        spans.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(spans) / calls * 1e6


def _union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_device(step, step_ms, steps=3):
    """Where a step's time goes (``step()`` runs one): ``torch.profiler``
    over a few more steps gives the device-busy time and the kernels that fill it; the idle
    share is taken against ``step_ms``, the step's wall time measured
    without the profiler (tracing slows the host many times over).  Busy
    time is the union of the device activities' intervals over all streams;
    ``stream_overlap_ms_per_step`` is the time two streams were busy at once
    (the pipelined step's side stream beside the current one).  Raises
    ``RuntimeError`` if the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    by_stream = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            by_stream.setdefault(e.device_resource_id, []).append(
                (e.time_range.start, e.time_range.end))
    union_ms = _union_us([iv for ivs in by_stream.values() for iv in ivs]) / 1e3
    per_stream = {str(k): _union_us(v) / 1e3 / steps for k, v in by_stream.items()}
    busy_ms = union_ms / steps
    return dict(
        steps=steps, step_ms_unprofiled=step_ms,
        device_busy_ms_per_step=busy_ms,
        device_kernel_ms_per_step=sum(r[1] for r in rows) / steps,
        busy_ms_per_step_by_stream=per_stream,
        stream_overlap_ms_per_step=sum(per_stream.values()) - busy_ms,
        device_idle_share=1.0 - busy_ms / step_ms,
        top_device_kernels=[{"name": k[:90], "ms_per_step": ms / steps,
                             "calls_per_step": c / steps}
                            for k, ms, c in rows[:12]])
