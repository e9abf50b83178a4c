"""Fault-tolerant training runtime (the reference's `repro.runtime`)."""
from .trainer import Trainer, TrainerConfig, TransientError

__all__ = ["Trainer", "TrainerConfig", "TransientError"]
