"""Training: the synchronous coded step and the trainer loop."""
from .coded_step import StepArtifacts, make_coded_train_step
from .trainer import Trainer

__all__ = ["Trainer", "make_coded_train_step", "StepArtifacts"]
