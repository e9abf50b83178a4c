"""Fault-tolerant training runtime (the reference's `repro.runtime`)."""
from .trainer import (Trainer, TrainerConfig, TransientError, grad_step,
                      state_specs)

__all__ = ["Trainer", "TrainerConfig", "TransientError", "grad_step",
           "state_specs"]
