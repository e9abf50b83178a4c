"""Channel clustering (Sense §III-B, Fig.4/Fig.7) — torch counterpart of
`repro.core.clustering`.

IFM sparsity is produced at runtime (ReLU), so it cannot be balanced by
offline training.  Sense ranks input channels by their nonzero counts and
co-schedules channels of approximate sparsity in the same PE-array step:
with a 1x2 array and NZE counts [8,4,8,3], natural order costs
max(8,4)+max(8,3)=16 while clustered order [8,8],[4,3] costs 8+4=12 — the
paper's 1.33x example.

Numerics are *permutation invariant* (channel contributions are summed), so
clustering changes only the schedule; this module provides the ranking, the
schedule, the crossbar/FIFO writeback model, and the step-cost accounting
consumed by `core.systolic`.  Ties (integer NZE counts tie constantly) keep
the lower channel first, as the reference's stable argsort does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


def channel_nze_counts(ifm: Tensor, *, channel_axis: int = 0) -> Tensor:
    """Nonzero count per channel: the N_NZEI stream the ranking unit sorts."""
    moved = torch.movedim(ifm, channel_axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    return (flat != 0).to(torch.int32).sum(dim=1, dtype=torch.int32)


def cluster_channels(nze) -> Tensor:
    """Channel permutation, descending NZE count (merge-sort in HW), ties
    to the lower channel.  Descending order packs the heaviest channels
    together so the per-group ``max`` is tight against the group mean."""
    return torch.argsort(-torch.as_tensor(nze), stable=True)


def grouped_step_costs(nze, group: int, *, clustered: bool = True) -> Tensor:
    """Per-step cost (= max NZE within each PE-row group of size ``group``).

    Channels are consumed ``group`` at a time (one per PE row); the systolic
    step time is the group max.  ``clustered=False`` models Swallow's natural
    channel order.  Tail group is padded with cost-0 channels.
    """
    nze = torch.as_tensor(nze).to(torch.int32)
    order = cluster_channels(nze) if clustered \
        else torch.arange(nze.shape[0], device=nze.device)
    sorted_nze = nze[order]
    pad = (-sorted_nze.shape[0]) % group
    padded = torch.cat([sorted_nze, sorted_nze.new_zeros(pad)])
    return padded.reshape(-1, group).max(dim=1).values


def schedule_cycles(nze, group: int, *, clustered: bool = True) -> Tensor:
    """Total step cycles for one pass over all channels."""
    return grouped_step_costs(nze, group, clustered=clustered).sum()


@dataclasses.dataclass
class ClusteringReport:
    permutation: np.ndarray
    cycles_clustered: int
    cycles_natural: int

    @property
    def speedup(self) -> float:
        return self.cycles_natural / max(self.cycles_clustered, 1)


def _report(nze: Tensor, group: int) -> ClusteringReport:
    return ClusteringReport(
        permutation=cluster_channels(nze).cpu().numpy(),
        cycles_clustered=int(schedule_cycles(nze, group, clustered=True)),
        cycles_natural=int(schedule_cycles(nze, group, clustered=False)))


def clustering_report(ifm: Tensor, group: int, *, channel_axis: int = 0
                      ) -> ClusteringReport:
    return _report(channel_nze_counts(ifm, channel_axis=channel_axis), group)


# ---------------------------------------------------------------------------
# Crossbar + FIFO writeback model (Fig.7): OFMs are written back
# channel-contiguously so the next layer can stream channels in clustered
# order.  Functionally this is a gather; the energy model charges it.
# ---------------------------------------------------------------------------

def crossbar_reorder(ofm: Tensor, perm: Tensor, *,
                     channel_axis: int = 0) -> Tensor:
    """Reorder OFM channels into clustered order (crossbar+FIFO writeback)."""
    return torch.index_select(ofm, channel_axis,
                              torch.as_tensor(perm, device=ofm.device).long())


def inverse_permutation(perm: Tensor) -> Tensor:
    inv = torch.zeros_like(perm)
    return inv.scatter_(0, perm.long(), torch.arange(
        perm.shape[0], dtype=perm.dtype, device=perm.device))


# ---------------------------------------------------------------------------
# LM extension: transformers under SiLU/GELU have no exact zeros; an
# optional top-k activation sparsifier re-creates the clustered schedule's
# precondition.  Off by default — an extension, not reproduction.
# ---------------------------------------------------------------------------

def activation_topk(x: Tensor, keep: int, *, axis: int = -1) -> Tensor:
    """Keep the ``keep`` largest-|x| entries along ``axis``, zero the rest
    (entries tied with the ``keep``-th magnitude are kept too)."""
    mag = x.abs()
    kth = torch.sort(mag, dim=axis, descending=True).values
    thresh = kth.narrow(axis, keep - 1, 1)
    return torch.where(mag >= thresh, x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


# ---------------------------------------------------------------------------
# FC weight-column clustering (§III-D): same ranking applied to the NZE
# counts of weight-matrix columns to balance outer-product steps.
# ---------------------------------------------------------------------------

def fc_column_clustering(w: Tensor, group: int) -> ClusteringReport:
    """Cluster FC weight columns by NZE count (w: [out, in], one column per
    input element's outer-product step)."""
    return _report((w != 0).to(torch.int32).sum(dim=0, dtype=torch.int32),
                   group)
