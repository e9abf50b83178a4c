"""Test-support utilities: the fault-injection harness (`faults`)."""
from . import faults

__all__ = ["faults"]
