"""Trainers of the port (the counterparts of `dl4ds_tpu/training`)."""

from .base import Trainer
from .supervised import SupervisedTrainer

__all__ = ['Trainer', 'SupervisedTrainer']
