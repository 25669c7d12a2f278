"""Training substrate: the fault-tolerant :class:`Trainer` and gradient
compression.  The reference's ``reshard`` (elastic re-meshing onto a
device mesh) waits for the port of ``launch/``."""
from .trainer import Trainer, TrainerConfig
from . import compression

__all__ = ["Trainer", "TrainerConfig", "compression"]
