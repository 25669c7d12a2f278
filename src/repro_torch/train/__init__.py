"""Training substrate: the fault-tolerant :class:`Trainer`, gradient
compression, and :func:`reshard` (a tree placed onto a DeviceMesh)."""
from .trainer import Trainer, TrainerConfig, reshard
from . import compression

__all__ = ["Trainer", "TrainerConfig", "compression", "reshard"]
