"""The served model families (the transformer: dense, audio, vlm, moe;
rwkv6; zamba2), their primitives and the params converter."""
from .api import build_model

__all__ = ["build_model"]
