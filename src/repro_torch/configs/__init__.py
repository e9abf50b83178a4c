"""Config registry: ``get_config("qwen3-8b")`` / ``get_smoke("qwen3-8b")``.

One module per assigned architecture; each exports CONFIG (published dims)
and SMOKE (reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib

from .base import (LONG_CONTEXT_FAMILIES, SHAPES, TRANSFORMER_FAMILIES,
                   ModelConfig, ShapeSpec, shape_applicable)

ARCHS = (
    "olmo-1b", "qwen3-8b", "starcoder2-7b", "command-r-plus-104b",
    "rwkv6-3b", "zamba2-1.2b", "musicgen-medium", "deepseek-moe-16b",
    "qwen3-moe-235b-a22b", "internvl2-2b",
)


def _module(arch: str):
    return importlib.import_module(
        f".{arch.replace('-', '_').replace('.', '_')}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def all_cells():
    """Every (arch, shape) cell of the assignment, with applicability."""
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, sspec in SHAPES.items():
            ok, why = shape_applicable(cfg, sname)
            cells.append((arch, sname, ok, why))
    return cells


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "get_smoke", "all_cells", "shape_applicable",
           "LONG_CONTEXT_FAMILIES", "TRANSFORMER_FAMILIES"]
