"""Device meshes and the card's constants — counterpart of
`repro.launch.mesh`.

The port runs on one GPU, so a mesh here is a description: axis names and
sizes (`Mesh`), which the sharding rules (`distributed.sharding`) and the
spec functions of the models and the plan read, so that their decisions
can be held against the reference's on the same axis sizes.  Nothing is
placed on devices by it.

* `make_host_mesh` — the one-device mesh ``(data=1, model=1)``, the mesh
  the port runs on;
* `make_production_mesh` — the reference's production axis sizes,
  ``(data=16, model=16)`` or ``(pod=2, data=16, model=16)``, as a
  description only.

The constants are the roofline denominators of one NVIDIA H100 SXM (80 GB
HBM3): dense bf16 tensor-core peak and device-memory rate from NVIDIA's
data sheet, the memory size as `torch.cuda.get_device_properties(0)
.total_memory` reads it on that card (NVIDIA H100 80GB HBM3, 700.00 W
power limit).  The reference's ``ICI_BW`` (a TPU pod's inter-chip link
rate) has no counterpart: on one device nothing crosses a link.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Tuple


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
