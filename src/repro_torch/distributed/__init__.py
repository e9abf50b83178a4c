"""Gradient compression and the sharding rules (the reference's
`repro.distributed.compress` and `repro.distributed.sharding`, the latter
over the port's own meshes: a description, or live `torch.distributed`
ranks)."""
from . import compress, sharding

__all__ = ["compress", "sharding"]
