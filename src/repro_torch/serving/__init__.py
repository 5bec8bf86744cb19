"""`repro_torch.serving`: generation and coded inference.

- ``BatchedEngine`` / ``build_serve_artifacts``: batched greedy generation
  on one device, a prefill (the flash attention kernel on the card above
  2048 tokens) and then one KV-cache decode step a token; the cache is
  updated in place.
- ``CodedServer`` + ``make_coded_forward``: the paper's ``(d, s, m)`` codes
  applied to batched forward passes.  Replicas compute ``d`` coded shards of
  the activations, the engine decodes the batch from the fastest ``n - s``
  replicas (the decode is bit-wise independent of straggler payloads), and
  ``partial`` specs serve past-``s`` failures under the ``ServeSLO`` error
  bound.  The server and ``make_coded_train_step`` construct from one
  ``repro_torch.coding.SchemeSpec``.  With ``autotune=ServingPolicy(...)``
  and a timed straggler source the server re-plans its uniform ``(d, s,
  m)`` by modeled p99 under a Poisson arrival process and swaps codes
  through a per-scheme artifact cache.
"""
from .batcher import Request, RequestBatcher
from .coded import ForwardArtifacts, failed_request_rows, make_coded_forward
from .engine import (BatchedEngine, BatchResult, CodedServer, ServeArtifacts,
                     ServeSLO, build_serve_artifacts)

__all__ = [
    "BatchedEngine",
    "BatchResult",
    "CodedServer",
    "ForwardArtifacts",
    "Request",
    "RequestBatcher",
    "ServeArtifacts",
    "ServeSLO",
    "build_serve_artifacts",
    "failed_request_rows",
    "make_coded_forward",
]
