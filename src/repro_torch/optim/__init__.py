"""Optimizers: NAG (the paper's), SGD-momentum, AdamW."""
from .optimizers import Optimizer, adamw, get_optimizer, nag, sgd_momentum

__all__ = ["Optimizer", "nag", "sgd_momentum", "adamw", "get_optimizer"]
