"""Gradient compression (the reference's `repro.distributed.compress`;
its sharding helpers are not ported)."""
from . import compress

__all__ = ["compress"]
