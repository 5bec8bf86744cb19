"""Data pipeline: redundant coded placement + synthetic batches."""
from .pipeline import (CodedBatcher, make_synthetic_batch,
                       synthetic_lm_stream, synthetic_logistic_dataset,
                       synthetic_stream)

__all__ = ["CodedBatcher", "make_synthetic_batch", "synthetic_lm_stream",
           "synthetic_stream", "synthetic_logistic_dataset"]
