"""Transformer models (dense and moe), their primitives and the params
converter."""
from .api import build_model

__all__ = ["build_model"]
