"""AdamW as plain functions on trees of tensors — counterpart of
`repro.optim.adamw` (no ``torch.optim``: its AdamW groups the arithmetic
differently).

Supports the Sense co-design's *mask-preserving* update: after each step
the pruning masks are re-applied, so retraining never resurrects a pruned
weight (the paper's prune -> retrain loop, Fig. 5).

The arithmetic follows the reference in its order: the global-norm clip,
bias corrections from ``step`` as f32, and ``p - lr * (m_hat / (sqrt(v_hat)
+ eps) + wd * p)`` in f32, cast back to the parameter's dtype.  Updates run
under ``torch.no_grad()`` and return new tensors: the state passed in is
left as it was, so a caller can retry a step from it.  ``adamw_update``
takes an optional gradient transform hook (`distributed.compress` plugs in
there).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..distributed import sharding as shd
from ..tree import (at_path, flatten_with_paths, leaves, tree_map,
                    unflatten)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> Tensor:
    """Linear warmup + cosine decay, f32 (a 0-d tensor on ``step``'s
    device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    """Zero moments in each parameter's dtype and an int32 step count, on
    the parameters' device."""
    zeros = lambda p: tree_map(torch.zeros_like, p)  # noqa: E731
    first = leaves(params)
    dev = first[0].device if first else None
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, mesh=None, specs=None) -> Tensor:
    """The L2 norm of every leaf of ``tree`` together.  On a live
    ``mesh`` the leaves are this rank's blocks laid out by ``specs`` (a
    tree of `distributed.sharding.P` of ``tree``'s structure): each
    leaf's sum of squares of its block is summed over the ranks of the
    axes its spec splits it over, in the order of their blocks (the sums
    of every leaf in one ``all_gather``), and the leaves are summed in
    tree order, so every rank holds the same bits and a replicated leaf
    counts once."""
    if mesh is None:
        return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))
    flat = flatten_with_paths(tree)
    parts = torch.stack([x.float().square().sum() for _, x in flat])
    every = shd.gather(parts[None], mesh, shd.P(tuple(mesh.axis_names)))
    mine = mesh.coord()
    total = 0.0
    for i, (path, _) in enumerate(flat):
        split = [a for d in at_path(specs, path) for a in shd.spec_axes(d)]
        split = tuple(a for a in mesh.axis_names if a in split)
        ranks = sorted((r for r in range(mesh.size)
                        if all(c == mine[a] for a, c in mesh.coord(r).items()
                               if a not in split)),
                       key=lambda r: mesh.index(split, r))
        leaf = every[ranks[0], i]
        for r in ranks[1:]:
            leaf = leaf + every[r, i]
        total = total + leaf
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, *,
                 grad_transform: Callable | None = None, mesh=None,
                 specs=None):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` (0-d f32 tensors).  On a live
    ``mesh`` the params, gradients and moments are this rank's blocks
    laid out by ``specs`` (the reference's ``opt_sh``: the moments placed
    as the params, ``step`` replicated): the update is elementwise on the
    blocks, with the clip scale of `global_norm` on the mesh."""
    if grad_transform is not None:
        grads, state = grad_transform(grads, state)
    gnorm = global_norm(grads, mesh, specs)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / gnorm.clamp(min=1e-9), max=1.0)
        grads = tree_map(lambda g: g.float() * scale, grads)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        mh = m / b1c
        vh = v / b2c
        new_p = p.float() - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                  + cfg.weight_decay * p)
        return new_p.to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state["m"]),
        leaves(state["v"]))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def apply_masks(params, masks):
    """Re-apply pruning masks after an update (mask-preserving retraining).

    ``masks`` mirrors a subset of the params tree; missing entries pass
    through unmasked."""
    if masks is None:
        return params

    def walk(p, m):
        if m is None:
            return p
        if isinstance(p, dict):
            return {k: walk(p[k], m.get(k)) if isinstance(m, dict) else p[k]
                    for k in p}
        return p * m
    return walk(params, masks)


def value_and_grad(loss_fn: Callable, params, *args, **kwargs):
    """``(loss, grads)`` of ``loss_fn(params, *args, **kwargs)`` with
    respect to every (floating) leaf of ``params``, by autograd; the
    gradient tree has ``params``' structure.  The params passed in are not
    modified: the loss sees detached copies that require grad."""
    flat = flatten_with_paths(params)
    for path, t in flat:
        if not t.is_floating_point():
            raise TypeError(f"value_and_grad: leaf {path} is {t.dtype}, "
                            "not floating")
    live = [t.detach().requires_grad_(True) for _, t in flat]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, live), *args, **kwargs)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(live, grads)]
    return loss.detach(), unflatten(params, grads)
