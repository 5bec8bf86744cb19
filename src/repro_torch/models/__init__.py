"""Model families ported so far: the paper's logistic regression."""
from . import api, linear

__all__ = ["api", "linear"]
