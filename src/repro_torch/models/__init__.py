"""Model families ported so far: the paper's logistic regression and the
dense decoder-only LM (its full-prompt prefill)."""
from . import api, common, dense, linear

__all__ = ["api", "common", "dense", "linear"]
