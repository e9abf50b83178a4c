"""Synthetic, checkpointable data streams (the reference's `repro.data`)."""
from .pipeline import DataConfig, SyntheticImageData, SyntheticLMData

__all__ = ["DataConfig", "SyntheticLMData", "SyntheticImageData"]
