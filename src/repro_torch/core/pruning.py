"""Load-balancing weight pruning (Sense §III-A) — torch counterpart of
`repro.core.pruning`.

Every output row keeps *exactly* the same number of nonzeros K (the
load-balance invariant), chosen as the row's K largest magnitudes with ties
broken by column index (stable sort), so the masks are identical to the
reference's on identical inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

Tensor = torch.Tensor


def keep_count(numel: int, sparsity: float) -> int:
    """Number of elements kept per kernel at a given sparsity ratio.

    ``sparsity`` is the *zero* fraction; at least one element is kept.
    """
    if not 0.0 <= sparsity < 1.0 + 1e-9:
        raise ValueError(f"sparsity must be in [0, 1], got {sparsity}")
    k = int(round(numel * (1.0 - sparsity)))
    return max(1, min(numel, k))


def topk_mask(w: Tensor, k: int) -> Tensor:
    """Bool mask of the K largest-|w| entries along the last axis, ties to
    the lower index (stable descending sort, as the reference's
    ``argsort(-|w|, stable=True)``)."""
    order = torch.argsort(-w.abs(), dim=-1, stable=True)
    mask = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    return mask.scatter_(-1, order[..., :k], True)


def balanced_prune_rows(w: Tensor, sparsity: float) -> Tuple[Tensor, Tensor]:
    """Prune a 2-D weight ``[out, in]`` so each row keeps exactly K
    largest-|w|.  Returns ``(pruned_weights, mask)`` (mask in w's dtype)."""
    if w.ndim != 2:
        raise ValueError(f"expected 2-D weights, got shape {tuple(w.shape)}")
    mask = topk_mask(w, keep_count(w.shape[1], sparsity)).to(w.dtype)
    return w * mask, mask


def balanced_prune_conv(w: Tensor, sparsity: float) -> Tuple[Tensor, Tensor]:
    """Prune conv weights ``[Co, Ci, Hk, Wk]`` per kernel (per output
    channel): every kernel keeps exactly ``K = keep_count(Ci*Hk*Wk)``
    elements, flattened in (Ci, Hk, Wk) order (Fig.5/Fig.6)."""
    if w.ndim != 4:
        raise ValueError(f"expected 4-D conv weights, got shape "
                         f"{tuple(w.shape)}")
    pruned, mask = balanced_prune_rows(w.reshape(w.shape[0], -1), sparsity)
    return pruned.reshape(w.shape), mask.reshape(w.shape)


def random_prune(w: Tensor, sparsity: float, *,
                 generator: torch.Generator | None = None,
                 by_magnitude: bool = True) -> Tuple[Tensor, Tensor]:
    """Unstructured pruning for FC layers (paper §III-D, after EIE [19]).

    ``by_magnitude=True`` keeps the globally largest-|w| fraction, ties to
    the lower flat index (the reference's stable sort); ``False`` keeps a
    uniformly random subset drawn from ``generator`` (ablation baseline).
    Returns ``(pruned_weights, mask)`` with the mask in w's dtype."""
    k = keep_count(w.numel(), sparsity)
    if by_magnitude:
        scores = w.abs().reshape(-1)
    else:
        if generator is None:
            raise ValueError("generator required for random (non-magnitude) "
                             "pruning")
        scores = torch.rand(w.numel(), generator=generator,
                            device=generator.device).to(w.device)
    mask = topk_mask(scores, k).reshape(w.shape).to(w.dtype)
    return w * mask, mask


@dataclasses.dataclass
class BalancedSparse:
    """K-nonzeros-per-row representation of a pruned ``[out, in]`` matrix:
    ``values[o, j]`` pairs with input column ``indices[o, j]``, ascending
    within each row.  Leaves may carry leading stacked axes."""
    values: Tensor   # [..., out, K]
    indices: Tensor  # [..., out, K] int32
    n_in: int

    @property
    def n_out(self) -> int:
        return self.values.shape[-2]

    @property
    def k(self) -> int:
        return self.values.shape[-1]

    @property
    def sparsity(self) -> float:
        return 1.0 - self.k / self.n_in

    def to_dense(self) -> Tensor:
        dense = torch.zeros((*self.values.shape[:-1], self.n_in),
                            dtype=self.values.dtype,
                            device=self.values.device)
        return dense.scatter_(-1, self.indices.long(), self.values)


def to_balanced_sparse(w: Tensor, sparsity: float | None = None,
                       k: int | None = None) -> BalancedSparse:
    """2-D matrix -> BalancedSparse keeping the top-K magnitudes per row
    (exactly one of ``sparsity`` / ``k``)."""
    if w.ndim != 2:
        raise ValueError(f"expected 2-D weights, got {tuple(w.shape)}")
    if (sparsity is None) == (k is None):
        raise ValueError("pass exactly one of sparsity / k")
    kk = k if k is not None else keep_count(w.shape[1], sparsity)
    idx = torch.argsort(-w.abs(), dim=1, stable=True)[:, :kk]
    idx = torch.sort(idx, dim=1).values
    return BalancedSparse(values=w.gather(1, idx),
                          indices=idx.to(torch.int32), n_in=w.shape[1])


def from_mask(w: Tensor, mask: Tensor) -> BalancedSparse:
    """BalancedSparse from an explicit balanced mask (equal row sums)."""
    nz = mask != 0
    counts = nz.sum(dim=1)
    if counts.numel() and not bool((counts == counts[0]).all()):
        raise ValueError("mask is not load-balanced: row NZE counts differ "
                         f"(min={int(counts.min())}, max={int(counts.max())})")
    k = int(counts[0]) if counts.numel() else 0
    idx = nonzero_columns(nz, k)
    vals = w.gather(1, idx) * nz.gather(1, idx)
    return BalancedSparse(values=vals, indices=idx.to(torch.int32),
                          n_in=w.shape[1])


def nonzero_columns(mask: Tensor, k: int) -> Tensor:
    """Ascending column indices (int64) of the K set entries per row of a
    balanced bool mask ``[..., rows, n]``."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1,
                         stable=True)[..., :k]


# ---------------------------------------------------------------------------
# Iterative prune -> retrain flow (paper Fig. 5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PruneScheduleResult:
    params: object
    masks: object
    history: list  # (sparsity, eval_metric) per iteration
    final_sparsity: float


def iterative_prune_retrain(
    params,
    *,
    target_sparsity: float,
    n_stages: int,
    prune_fn: Callable,          # (params, sparsity) -> (params, masks)
    retrain_fn: Callable,        # (params, masks) -> params   (mask-preserving)
    eval_fn: Callable,           # (params) -> float            (higher better)
    accuracy_floor: float | None = None,
) -> PruneScheduleResult:
    """Gradual prune -> retrain -> test loop of Fig. 5.

    Sparsity ramps with the cubic schedule of Zhu & Gupta from 0 to
    ``target_sparsity`` over ``n_stages``.  After each stage the model is
    retrained with the masks held fixed and evaluated; if ``accuracy_floor``
    is given and the metric drops below it, the loop stops and returns the
    last acceptable stage (the paper: "testify if the accuracy drops out of
    boundary ... otherwise save the final pruned weights").
    """
    history = []
    best = (params, None, 0.0)
    for stage in range(1, n_stages + 1):
        frac = stage / n_stages
        sparsity = target_sparsity * (1.0 - (1.0 - frac) ** 3)
        pruned, masks = prune_fn(params, sparsity)
        pruned = retrain_fn(pruned, masks)
        metric = float(eval_fn(pruned))
        history.append((sparsity, metric))
        if accuracy_floor is not None and metric < accuracy_floor:
            break
        params, best = pruned, (pruned, masks, sparsity)
    final_params, final_masks, final_sparsity = best
    return PruneScheduleResult(params=final_params, masks=final_masks,
                               history=history, final_sparsity=final_sparsity)


def nze_counts(x: Tensor, axis: int | tuple = -1) -> Tensor:
    """Nonzero-element counts along ``axis`` (the paper's N_NZE*)."""
    return (x != 0).to(torch.int32).sum(dim=axis, dtype=torch.int32)


def load_imbalance(nze) -> float:
    """max/mean NZE ratio: 1.0 == perfectly balanced (Sense's invariant)."""
    nze = torch.as_tensor(nze).to(torch.float32)
    mean = nze.mean()
    return float(torch.where(mean > 0, nze.max() / mean.clamp(min=1e-9),
                             torch.ones((), device=nze.device)))
