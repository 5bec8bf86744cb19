"""Request admission + batching for the coded serving engine.

The coded forward runs at one fixed global batch ``B = k * b`` (the coded
layout is a static shard_map signature — varying B would retrace).  The
batcher absorbs a ragged request stream into that rigid shape: requests
queue FIFO, ``next_batch`` drains up to ``B`` of them, zero-pads the tail
rows and stacks per-request payloads into the engine's batch dict.  Padding
rows cost compute but never correctness (their outputs are dropped on the
way out), matching the queue model :func:`repro.tune.simulate_queue` prices.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request: an id + per-request feature dict (no batch
    dim) — e.g. ``{"x": (l,)}`` for the linear family, ``{"tokens": (S,)}``
    for the LM families — plus its arrival timestamp (seconds; feeds the
    per-request sojourn telemetry)."""

    req_id: int
    payload: dict[str, Any]
    arrival_s: float = 0.0


class RequestBatcher:
    """FIFO queue that drains into fixed-size engine batches.

    ``batch_requests`` is the engine's global batch ``B``; ``next_batch``
    returns ``(requests, batch_dict, valid)`` where ``batch_dict`` stacks
    the drained payloads to exactly ``B`` rows (zero rows past ``valid``).
    """

    def __init__(self, batch_requests: int):
        """``batch_requests``: the engine's fixed global batch size B."""
        if batch_requests < 1:
            raise ValueError(f"batch_requests must be >= 1, "
                             f"got {batch_requests}")
        self.batch_requests = int(batch_requests)
        self._queue: deque[Request] = deque()

    def __len__(self) -> int:
        """Requests currently queued."""
        return len(self._queue)

    def add(self, req: Request) -> None:
        """Enqueue one request (FIFO)."""
        self._queue.append(req)

    def next_batch(self) -> tuple[list[Request], dict[str, np.ndarray], int]:
        """Drain up to ``B`` requests into one zero-padded engine batch.

        Raises if the queue is empty (the engine only dispatches when work
        exists); returns the drained requests in dispatch order, the
        stacked ``(B, ...)`` batch dict, and the count of valid rows.
        """
        if not self._queue:
            raise ValueError("no queued requests to batch")
        B = self.batch_requests
        reqs = [self._queue.popleft()
                for _ in range(min(B, len(self._queue)))]
        keys = reqs[0].payload.keys()
        batch: dict[str, np.ndarray] = {}
        for key in keys:
            rows = [np.asarray(r.payload[key]) for r in reqs]
            first = rows[0]
            out = np.zeros((B,) + first.shape, first.dtype)
            for i, row in enumerate(rows):
                if row.shape != first.shape:
                    raise ValueError(
                        f"ragged payloads for {key!r}: {row.shape} vs "
                        f"{first.shape} — pad requests to one shape "
                        f"before enqueueing")
                out[i] = row
            batch[key] = out
        return reqs, batch, len(reqs)
