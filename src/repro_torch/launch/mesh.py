"""Device meshes and the card's constants — counterpart of
`repro.launch.mesh`.

Two kinds of mesh, both with ``axis_names``, ``axis_sizes``, ``shape``
and ``size``, so the sharding rules (`distributed.sharding`) and the spec
functions of the models and the plan read either unchanged:

* `Mesh` — a description: axis names and sizes, no devices.  The dry run
  (`launch.dryrun`) sums one device's shards of the reference's
  production meshes on it, and the spec decisions are held against the
  reference's on it.
  * `make_host_mesh` — the one-device mesh ``(data=1, model=1)``;
  * `make_production_mesh` — the reference's production axis sizes,
    ``(data=16, model=16)`` or ``(pod=2, data=16, model=16)``.
* `LiveMesh` (`init_mesh`) — a mesh of live `torch.distributed` ranks,
  one rank a device of the reference's mesh: the rank's coordinate (rank
  ``r`` at the row-major position ``r`` of the axis sizes, as the
  reference lays its devices out) and one process group per set of axes.
  Tensors are placed on it by `distributed.sharding.place`: a rank holds
  the shards the reference's specs give its device.

The constants are the roofline denominators of one NVIDIA H100 SXM (80 GB
HBM3): dense bf16 tensor-core peak and device-memory rate from NVIDIA's
data sheet, the memory size as `torch.cuda.get_device_properties(0)
.total_memory` reads it on that card (NVIDIA H100 80GB HBM3, 700.00 W
power limit).  The reference's ``ICI_BW`` (a TPU pod's inter-chip link
rate) has no counterpart: the live mesh's ranks share one card over
``gloo``, and nothing crosses a link between cards.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes, in order (a description: no
    devices)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} and {self.axis_sizes} "
                             f"differ in length")

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


@dataclasses.dataclass(frozen=True, eq=False)
class LiveMesh:
    """A mesh of live `torch.distributed` ranks (`init_mesh`): the axes
    and their sizes as `Mesh` has them, this process's ``rank``, the
    ``device`` its tensors live on and one process group per set of axes
    whose sizes multiply past 1 (``groups``, keyed by the frozenset of
    axis names)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    groups: Dict[frozenset, Any]

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coord(self, rank: int | None = None) -> Dict[str, int]:
        """Axis name -> the position of ``rank`` (default: this one) on
        it, ranks laid out row-major over the axes."""
        rank = self.rank if rank is None else rank
        out = {}
        for name, n in reversed(list(zip(self.axis_names,
                                         self.axis_sizes))):
            out[name] = rank % n
            rank //= n
        return {name: out[name] for name in self.axis_names}

    def index(self, axes, rank: int | None = None) -> int:
        """The block ``rank`` holds of a dim split over ``axes`` (a name or
        a tuple of names, the first the major one, as the reference
        splits a dim over a tuple of axes)."""
        c = self.coord(rank)
        i = 0
        for a in spec_axes(axes):
            i = i * self.shape[a] + c[a]
        return i

    def group(self, axes):
        """The process group of this rank over the set of ``axes`` (None
        where they hold this rank alone)."""
        return self.groups.get(frozenset(spec_axes(axes)))

    def group_ranks(self, axes, rank: int | None = None) -> list:
        """The global ranks of ``rank``'s (default: this one's) group over
        ``axes``, ascending (the order `torch.distributed.all_gather`
        fills its list in)."""
        names = set(spec_axes(axes))
        mine = self.coord(rank)
        return [r for r in range(self.size)
                if all(c == mine[a] for a, c in self.coord(r).items()
                       if a not in names)]

    def close(self) -> None:
        """Tear the process groups down."""
        torch.distributed.destroy_process_group()


def spec_axes(axes) -> tuple:
    """The axis names of one dim's spec entry (None, a name or a tuple),
    as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def init_mesh(axis_names, axis_sizes, *, rank: int, world_size: int,
              backend: str, init_method: str, device) -> LiveMesh:
    """Join the ``world_size`` ranks at ``init_method`` (``file://`` or
    ``tcp://``; nothing is read from the environment) and build one
    process group per set of axes, every rank creating every group in the
    same order, as `torch.distributed.new_group` requires.  The groups are
    built with `new_group` rather than `torch.distributed.device_mesh`,
    whose groups over a tuple of axes (``("data", "pod")``) need its
    version-dependent flattening: a group over a set of axes holds the
    ranks that agree on every other axis, and the order of the axes
    within a dim's split is kept by `LiveMesh.index`, not by the
    group."""
    axis_names, axis_sizes = tuple(axis_names), tuple(axis_sizes)
    if len(axis_names) != len(axis_sizes):
        raise ValueError(f"{axis_names} and {axis_sizes} differ in length")
    if math.prod(axis_sizes) != world_size:
        raise ValueError(f"mesh {dict(zip(axis_names, axis_sizes))} holds "
                         f"{math.prod(axis_sizes)} ranks, not {world_size}")
    dist = torch.distributed
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    mesh = LiveMesh(axis_names, axis_sizes, rank, torch.device(device), {})
    for r in range(1, len(axis_names) + 1):
        for axes in itertools.combinations(axis_names, r):
            if math.prod(mesh.shape[a] for a in axes) == 1:
                continue
            seen = set()
            for other in range(world_size):
                members = tuple(mesh.group_ranks(axes, other))
                if members in seen:
                    continue
                seen.add(members)
                g = dist.new_group(list(members))
                if rank in members:
                    mesh.groups[frozenset(axes)] = g
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh sizes: one pod ``(16, 16)`` over
    ``(data, model)``, two pods ``(2, 16, 16)`` over ``(pod, data,
    model)``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """The one-device mesh the port runs on."""
    return Mesh(("data", "model"), (1, 1))


# NVIDIA H100 SXM 80 GB (roofline denominators)
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # device-memory bytes/s
HBM_BYTES = 85_017_493_504      # total_memory as read on the card
