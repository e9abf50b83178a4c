"""Model API — counterpart of `repro.models.api`: every model family the
reference serves (the transformer families dense, audio, vlm and moe;
ssm: rwkv6; hybrid: zamba2) behind one bundle.

``build_model(cfg, device)`` returns a `ModelBundle` of plain functions on
tensors:

* ``init(seed) -> params``                  (stacked ``[L, ...]`` layers)
* ``train_loss(params, batch) -> loss``     (0-d f32, differentiable)
* ``prefill(params, batch) -> (logits_last, cache)``
* ``decode_step(params, batch, cache) -> (logits, cache)``
* ``init_cache(batch, max_len) -> cache``   (the transformer: plane layout
  ``[L, B*KH, S, dh]``; rwkv6: token-shift and WKV states; zamba2: SSM and
  conv states plus the shared block's ``[n_attn, B, S, KH, dh]`` KV)
* ``merge(cache, prefill_cache) -> cache`` (a decode cache seeded with a
  prefill's: `merge_prefill_cache`, or the bundle's own ``merge_cache``)
* ``param_specs() -> specs`` / ``cache_specs(batch) -> specs``  (the
  reference's sharding decisions for the params and the cache on the
  mesh the bundle was built with, ``build_model(cfg, device, mesh=...)``;
  ``P()`` leaves without a mesh)

On a description (`launch.mesh.Mesh`) the specs are decisions only.  On a
live mesh (`launch.mesh.LiveMesh`) every family's bundle runs the
reference's sharded serve program (`models.transformer`, `models.rwkv6`,
`models.zamba2`): ``init(seed)``
makes the params whole from the seed on every rank and places them
(`distributed.sharding.place_tree`; converted params are placed the same
way), ``init_cache`` gives this rank's block of the cache, and ``prefill`` /
``decode_step`` take and return the whole batch, each rank computing its
block of rows (`distributed.sharding.shard_batch`, as
`batch_partition_spec` splits it).

``input_specs(cfg, shape)`` gives one (arch, shape) cell's batch as
tensors on the ``meta`` device (no allocation), ``init_shapes(cfg)`` the
params the same way, and ``param_specs(cfg, mesh)`` /
``batch_partition_spec(cfg, shape, mesh)`` the reference's sharding
decisions over a `launch.mesh.Mesh` (`distributed.sharding`).  Each family
module registers its build function under the ``cfg.family`` names it
serves (`register_family`), and every entry point here dispatches through
that registry.

The Sense serving path: when ``cfg.sparse_serving`` and the caller attached
a plan (``params["sparse_plan"]``, from `engine.plan.plan_model`), every
planned projection runs through the balanced-sparse kernels.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Dict

import torch

from ..configs.base import ModelConfig, ShapeSpec
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
    param_specs: Callable[[], Any]
    cache_specs: Callable[[int], Any]
    merge_cache: Callable[[Any, Any], Any] | None = None

    def merge(self, cache, prefill_cache):
        """``cache`` (from ``init_cache``) seeded with a prefill's cache:
        the bundle's own ``merge_cache`` where it has one (a live mesh's
        rank whose cache holds a block of the sequence), else
        `merge_prefill_cache`."""
        return (self.merge_cache or merge_prefill_cache)(cache,
                                                         prefill_cache)


@dataclasses.dataclass(frozen=True)
class BlockDiff:
    """One block of a teacher-forced comparison of two param sets (the
    families' ``sublayer_diffs``).  ``increments`` holds per sublayer
    ``(name, got, want)``: the tensors each side adds to the residual
    (after their cast to its dtype), both computed from the reference's
    input to that sublayer; ``out`` / ``ref_out`` are the block outputs
    assembled from them, ``h + inc_1 + inc_2 ...`` on each side, and
    ``agree`` an MoE block's routing agreement (None elsewhere)."""
    block: str
    out: Tensor
    ref_out: Tensor
    agree: float | None
    increments: tuple


_REGISTRY: Dict[str, Callable[[ModelConfig, torch.device], ModelBundle]] = {}


def register_family(*families: str):
    """Register a family's ``build(cfg, device, mesh=None)`` under each
    ``cfg.family`` it serves.  Every entry point below dispatches through
    this registry: the module that defines the registered ``build`` also
    serves the family's ``init_params``, ``param_specs``, ``cache_specs`` and
    ``sublayer_diffs``."""
    def deco(fn):
        for name in families:
            _REGISTRY[name] = fn
        return fn
    return deco


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


def _family_build(cfg: ModelConfig):
    """The ``build`` registered for ``cfg.family``."""
    from . import rwkv6, transformer, zamba2  # noqa: F401  (they register)
    try:
        return _REGISTRY[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}") from None


def _family_module(cfg: ModelConfig):
    """The module that registered ``cfg.family``."""
    return sys.modules[_family_build(cfg).__module__]


def build_model(cfg: ModelConfig, device=None, mesh=None) -> ModelBundle:
    """The family's bundle on ``device`` (default: the GPU; a missing GPU
    raises unless ``device="cpu"``), its specs decided on ``mesh`` (a
    `launch.mesh.Mesh`; None: ``P()`` leaves), or sharded over it (a
    `launch.mesh.LiveMesh`: this rank's part of the program)."""
    return _family_build(cfg)(cfg, resolve_device(device), mesh=mesh)


def init_shapes(cfg: ModelConfig) -> dict:
    """The family's params as ``meta`` tensors (shapes and dtypes, no
    storage and no draws)."""
    return _family_module(cfg).init_params(cfg, torch.Generator(),
                                           torch.device("meta"))


def param_specs(cfg: ModelConfig, mesh) -> dict:
    """The family's parameter specs on ``mesh`` (`distributed.sharding`;
    ``P()`` for every leaf without a mesh)."""
    return _family_module(cfg).param_specs(cfg, mesh)


def cache_specs(cfg: ModelConfig, mesh, batch_size: int) -> dict:
    """The family's cache specs for ``batch_size`` sequences on ``mesh``
    (``P()`` for every leaf without a mesh)."""
    return _family_module(cfg).cache_specs(cfg, mesh, batch_size)


def sublayer_diffs(cfg: ModelConfig, params, ref_params, tokens: Tensor,
                   **kwargs):
    """The family's teacher-forced per-sublayer comparison of two param
    sets: one `BlockDiff` per block, yielded block by block."""
    return _family_module(cfg).sublayer_diffs(cfg, params, ref_params,
                                              tokens, **kwargs)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Batch:
    """One (arch, shape) cell's batch as ``meta`` tensors: ``tokens``
    (int32 ``[b, s]``, or ``[b, 1]`` with ``cache_len`` ``[b]`` for a
    decode cell) and, for a model with a frontend outside decode, the
    precomputed frame / patch embeddings ``frontend_embed`` (bf16 ``[b,
    min(n_frontend_tokens, s), frontend_dim]``)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        specs: Batch = {"tokens": spec((b, 1), torch.int32),
                        "cache_len": spec((b,), torch.int32)}
    else:
        specs = {"tokens": spec((b, s), torch.int32)}
    if cfg.frontend and shape.kind != "decode":
        specs["frontend_embed"] = spec(
            (b, min(cfg.n_frontend_tokens, s), cfg.frontend_dim),
            torch.bfloat16)
    return specs


def batch_partition_spec(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Batch:
    """Specs matching `input_specs`: the batch over the longest prefix of
    the dp axes that divides it (`distributed.sharding.shard_batch`)."""
    from ..distributed import sharding as shd
    dp = shd.shard_batch(mesh, shape.global_batch)
    specs: Batch = {"tokens": shd.P(dp, None)}
    if shape.kind not in ("train", "prefill"):
        specs["cache_len"] = shd.P(dp)
    if cfg.frontend and shape.kind != "decode":
        specs["frontend_embed"] = shd.P(dp, None, None)
    return specs
