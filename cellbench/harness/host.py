"""What the host did while a window ran: the process's CPU time, the times
its main thread was switched out, and the pauses of Python's garbage
collector.  Read from ``os``, ``/proc/self/status`` and ``gc``; where the
kernel keeps no count of switches, that reading is left out.  A driver notes
them beside the window's walls, so that a slow or spread run can be told
apart as the host's or the card's."""
from __future__ import annotations

import gc
import os
import pathlib
import time


def _proc(path: str) -> str | None:
    try:
        return pathlib.Path(path).read_text()
    except OSError:
        return None


def _switches() -> dict:
    text = _proc("/proc/self/status") or ""
    out = {}
    for line in text.splitlines():
        key, _, value = line.partition(":")
        if key.endswith("ctxt_switches"):
            out[key] = int(value)
    return out


class HostProbe:
    """``with HostProbe() as p: ...``; then ``p.reading()``."""

    def __enter__(self):
        self._gc = {"collections": [0, 0, 0], "seconds": [0.0, 0.0, 0.0],
                    "longest_s": 0.0}
        self._gc_t0 = None
        gc.callbacks.append(self._on_gc)
        self._t0, self._cpu0 = time.perf_counter(), os.times()
        self._sw0 = _switches()
        return self

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            dt = time.perf_counter() - self._gc_t0
            g = info["generation"]
            self._gc["collections"][g] += 1
            self._gc["seconds"][g] += dt
            self._gc["longest_s"] = max(self._gc["longest_s"], dt)
            self._gc_t0 = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        self._wall = time.perf_counter() - self._t0
        cpu1 = os.times()
        self._cpu_s = ((cpu1.user - self._cpu0.user)
                       + (cpu1.system - self._cpu0.system))
        self._sw1 = _switches()
        return False

    def reading(self) -> dict:
        out = {"wall_s": self._wall, "process_cpu_s": self._cpu_s,
               "gc": self._gc}
        for k, v in self._sw1.items():
            out[k] = v - self._sw0.get(k, 0)
        return out
