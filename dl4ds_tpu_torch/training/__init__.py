"""Trainers of the port (the counterparts of `dl4ds_tpu/training`)."""

from .base import Trainer
from .supervised import SupervisedTrainer
from .cgan import CGANTrainer, load_checkpoint, train_step

__all__ = ['Trainer', 'SupervisedTrainer', 'CGANTrainer', 'load_checkpoint',
           'train_step']
