"""Training: the synchronous and the pipelined coded step, and the trainer
loop."""
from .coded_step import (StepArtifacts, make_coded_train_step,
                         pipelining_supported)
from .pipeline import PipelineDriver, PipelineFns
from .trainer import Trainer

__all__ = ["Trainer", "make_coded_train_step", "StepArtifacts",
           "PipelineDriver", "PipelineFns", "pipelining_supported"]
