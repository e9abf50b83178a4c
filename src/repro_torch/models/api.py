"""Model API — counterpart of `repro.models.api` for the transformer
families this package serves (dense and moe).

``build_model(cfg, device)`` returns a `ModelBundle` of plain functions on
tensors:

* ``init(seed) -> params``                  (stacked ``[L, ...]`` layers)
* ``train_loss(params, batch) -> loss``     (0-d f32, differentiable)
* ``prefill(params, batch) -> (logits_last, cache)``
* ``decode_step(params, batch, cache) -> (logits, cache)``
* ``init_cache(batch, max_len) -> cache``   (plane layout ``[L, B*KH, S, dh]``)

The Sense serving path: when ``cfg.sparse_serving`` and the caller attached
a plan (``params["sparse_plan"]``, from `engine.plan.plan_model`), every
planned projection runs through the balanced-sparse kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..configs.base import TRANSFORMER_FAMILIES, ModelConfig
from ..device import resolve_device

Tensor = torch.Tensor
Batch = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[int], Any]
    train_loss: Callable[[Any, Batch], Any]
    prefill: Callable[[Any, Batch], tuple]
    decode_step: Callable[[Any, Batch, Any], tuple]
    init_cache: Callable[[int, int], Any]


def planned_proj(lp, plan_layers, name: str, x: Tensor, cd) -> Tensor:
    """One projection ``x @ lp[name]``, routed through the plan's
    balanced-sparse kernels when the layer is planned (plan weights are
    output-major ``[O, N] = W.T``, so `apply_fc` computes the same x @ W)."""
    if plan_layers is not None and name in plan_layers:
        from ..engine.execute import apply_fc
        return apply_fc(x, plan_layers[name]).to(cd)
    return x @ lp[name].to(cd)


def serving_plan(cfg: ModelConfig, params):
    """The offline projection plan when sparse serving is on and one is
    attached (``params["sparse_plan"]``)."""
    if cfg.sparse_serving and isinstance(params, dict):
        return params.get("sparse_plan")
    return None


def merge_prefill_cache(cache: dict, prefill_cache: dict) -> dict:
    """Seed a full-length decode cache with a prefill pass's cache: leaves
    of equal shape are taken whole; KV leaves (shorter sequence axis) are
    written at offset 0 of the one axis that differs."""
    out = {}
    for key, z in cache.items():
        pf = prefill_cache[key]
        if z.shape == pf.shape:
            out[key] = pf.to(z.dtype)
            continue
        diff = [i for i, (a, b) in enumerate(zip(z.shape, pf.shape))
                if a != b]
        if z.ndim != pf.ndim or len(diff) != 1 \
                or pf.shape[diff[0]] > z.shape[diff[0]]:
            raise ValueError(f"prefill cache leaf {tuple(pf.shape)} does not "
                             f"embed in decode cache leaf {tuple(z.shape)}")
        merged = z.clone()
        merged.narrow(diff[0], 0, pf.shape[diff[0]]).copy_(pf)
        out[key] = merged
    return out


def build_model(cfg: ModelConfig, device=None) -> ModelBundle:
    """The transformer bundle on ``device`` (default: the GPU; a missing
    GPU raises unless ``device="cpu"``)."""
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise ValueError(f"this package serves the {TRANSFORMER_FAMILIES} "
                         f"families, got {cfg.family!r}")
    from . import transformer
    return transformer.build(cfg, resolve_device(device))
