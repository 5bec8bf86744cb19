"""Host-side driver for the async pipelined coded step.

The pipelined step (``make_coded_train_step(..., spec=SchemeSpec(
pipelined=True))``) splits one training iteration into three callables so the
decode of step t overlaps the forward/backward of step t+1 (stale-by-one
aggregation):

  fill    (params, batch, mask, rho)                   -> wire state
  steady  (params, opt, batch, W, mask, rho, *wire)    -> (params', opt',
                                                           metrics, *wire')
  drain   (params, opt, W, *wire)                      -> (params', opt',
                                                           metrics)

The *wire state* is one flat buffer per ``PackPlan`` bucket (the (n, L_b)
stack of every worker's masked encodings) plus one (n, S) f32 *side* buffer
carrying the psum-fallback leaves and the masked loss scalar.  ``steady``
decodes the in-flight buffers with the decode weights ``W`` of the pattern
drawn when they were encoded, applies the update, and encodes the current
batch at the *pre-update* params: the two halves share no data, so on the
card the decode half runs on a side CUDA stream while the encode half runs
on the current one.

``PipelineDriver`` owns the host bookkeeping of that protocol: it threads
the wire state between calls, holds the *pending* decode weights (each
call's W applies to the buffers encoded on that call, so it is consumed one
call later), fills on first use, and drains on its own when the batch shape
changes.  Parity contract: fill followed immediately by drain reproduces the
synchronous step bit for bit on the same batch; the steady state differs
from synchronous SGD only by the one step of gradient staleness.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping


@dataclasses.dataclass(frozen=True)
class PipelineFns:
    """The three pipelined callables of one step build.

    ``num_buffers`` is the wire-state arity (one buffer per pack-plan bucket
    plus the side buffer): the trailing ``*wire`` argument and return counts
    of ``steady`` / ``drain``.
    """
    fill: Callable
    steady: Callable
    drain: Callable
    num_buffers: int


def _shape_sig(batch: Mapping[str, Any]) -> tuple:
    return tuple((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items())


class PipelineDriver:
    """Stateful host loop around one pipelined ``StepArtifacts``.

    ``step(params, opt_state, batch, W, mask, rho)`` returns
    ``(params', opt_state', metrics_or_None)``: the first call fills the
    pipeline (no update yet: metrics is None), every later call runs one
    steady-state step whose metrics describe the *previous* batch (its
    gradient is the one applied).  ``drain(params, opt_state)`` retires the
    in-flight buffers and returns the final update and its metrics.

    Each call's ``W`` is kept as *pending*: the decode weights of a
    straggler pattern apply to the wire encoded under that pattern's
    mask / rho, which the *next* call consumes.  A batch-shape change
    mid-flight triggers a drain first; its metrics are returned by the fill
    call that follows.
    """

    def __init__(self, arts: Any):
        if arts.pipeline is None:
            raise ValueError("step was not built with pipelined=True")
        self.fns: PipelineFns = arts.pipeline
        self._shape_key: tuple | None = None
        self._state: tuple | None = None
        self._pending_W = None

    @property
    def in_flight(self) -> bool:
        """True when wire buffers are pending a decode (drain before
        abandoning this driver)."""
        return self._state is not None

    def step(self, params, opt_state, batch, W, mask, rho):
        """Advance the pipeline by one batch; see the class docstring."""
        metrics = None
        key = _shape_sig(batch)
        if self._state is not None and key != self._shape_key:
            params, opt_state, metrics = self.drain(params, opt_state)
        self._shape_key = key
        if self._state is None:
            self._state = tuple(self.fns.fill(params, batch, mask, rho))
            self._pending_W = W
            return params, opt_state, metrics
        out = self.fns.steady(params, opt_state, batch, self._pending_W,
                              mask, rho, *self._state)
        params, opt_state, metrics = out[0], out[1], out[2]
        self._state = tuple(out[3:])
        self._pending_W = W
        return params, opt_state, metrics

    def drain(self, params, opt_state):
        """Retire the in-flight wire: decode + apply the pending gradient.
        Returns ``(params', opt_state', metrics)``."""
        if self._state is None:
            raise RuntimeError("nothing in flight to drain")
        params, opt_state, metrics = self.fns.drain(
            params, opt_state, self._pending_W, *self._state)
        self._state = None
        self._pending_W = None
        return params, opt_state, metrics
