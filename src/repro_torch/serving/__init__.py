"""`repro_torch.serving`: coded inference.

The coded inference engine (``CodedServer`` + ``make_coded_forward``): the
paper's ``(d, s, m)`` codes applied to batched forward passes.  Replicas
compute ``d`` coded shards of the activations, the engine decodes the batch
from the fastest ``n - s`` replicas (the decode is bit-wise independent of
straggler payloads), and ``partial`` specs serve past-``s`` failures under
the ``ServeSLO`` error bound.  The server and ``make_coded_train_step``
construct from one ``repro_torch.coding.SchemeSpec``.

Not ported yet: the KV-cache decode surface (``BatchedEngine``,
``build_serve_artifacts``) and the serving auto-tuner.
"""
from .batcher import Request, RequestBatcher
from .coded import ForwardArtifacts, failed_request_rows, make_coded_forward
from .engine import BatchResult, CodedServer, ServeSLO

__all__ = [
    "BatchResult",
    "CodedServer",
    "ForwardArtifacts",
    "Request",
    "RequestBatcher",
    "ServeSLO",
    "failed_request_rows",
    "make_coded_forward",
]
