"""Megabytes a worker receives through the worker group's collectives in
a training step (the program's ``Comm.bytes`` counter over the traced
window's steps)."""


def read(trace):
    got = trace.counters.get("comm_bytes")
    if not got:
        return None
    return got / trace.work["steps"] / 1e6
