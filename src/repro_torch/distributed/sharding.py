"""Sharding rules — counterpart of `repro.distributed.sharding`, over the
port's own `launch.mesh.Mesh`.

The reference maps its production mesh ``(data, model)`` (or ``(pod,
data, model)``) onto every parameter and activation:

* ``model`` — tensor parallel: attention heads, d_ff columns, vocab rows,
  MoE experts;
* ``data``  — batch data-parallel and FSDP: the non-TP dim of every large
  parameter;
* ``pod``   — pure data parallel, composed with ``data`` for the batch.

Every rule is divisibility-guarded: a dim is sharded over an axis only if
the axis size divides it.  The port runs on one device, so the rules here
decide the same specs (tuples of axis names, `P`) for a mesh that
describes axis sizes, and nothing is placed: `named`, `tree_shardings`,
`with_hidden_sharding` and `with_channel_sharding` return what they are
given.  The decisions equal the reference's on every mesh, which is what
lets a spec be reasoned about here before a multi-device port exists;
`shard_shape` turns a decision into one device's shard, which the dry
run's production-mesh records sum into per-device bytes.
"""
from __future__ import annotations

from typing import Sequence

from ..launch.mesh import Mesh


class P(tuple):
    """A partition spec: one entry per dim, each ``None`` (replicated), an
    axis name or a tuple of axis names.  As ``jax.sharding.PartitionSpec``
    normalizes them, a one-name tuple is stored as the name and an empty
    tuple as ``None``, so ``tuple(spec)`` compares equal across the two."""

    def __new__(cls, *dims):
        def norm(d):
            if isinstance(d, (tuple, list)):
                d = tuple(d)
                return None if not d else (d[0] if len(d) == 1 else d)
            return d
        return super().__new__(cls, (norm(d) for d in dims))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(d) for d in self) + ")"


def dp_axes(mesh: Mesh) -> tuple:
    """Data-parallel axes in order (pod outermost when present)."""
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def fsdp_axes(mesh: Mesh) -> tuple:
    """Axes parameters are FSDP-sharded over (data first, then pod)."""
    return tuple(n for n in ("data", "pod") if n in mesh.axis_names)


def _axes_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def dim_spec(mesh: Mesh, dim_size: int, *candidates):
    """First candidate (axis name or tuple of names) that divides
    ``dim_size``; None (replicated) when nothing divides.  A candidate
    tuple is tried whole, then shrunk from the right; axes the mesh lacks
    are dropped first."""
    shape = mesh.shape
    for cand in candidates:
        if cand is None:
            return None
        if isinstance(cand, str):
            cand = (cand,)
        cand = tuple(a for a in cand if a in shape)
        while cand:
            if dim_size % _axes_size(mesh, cand) == 0:
                return cand if len(cand) > 1 else cand[0]
            cand = cand[:-1]
    return None


def _not_used(cand, used: set) -> bool:
    if cand is None:
        return True
    names = (cand,) if isinstance(cand, str) else tuple(cand)
    return not any(n in used for n in names)


def logical_spec(mesh: Mesh, shape: Sequence[int], plan: Sequence) -> P:
    """The spec of ``shape``: ``plan[i]`` lists dim i's axis candidates
    (``[]`` / None replicates it); an axis is used by one dim at most."""
    dims = []
    used: set = set()
    for size, cands in zip(shape, plan):
        if not cands:
            dims.append(None)
            continue
        cands = [c for c in cands if _not_used(c, used)]
        d = dim_spec(mesh, size, *cands)
        if d is not None:
            used.update((d,) if isinstance(d, str) else d)
        dims.append(d)
    return P(*dims)


def shard_batch(mesh: Mesh, batch_size: int) -> tuple | None:
    """The dp axes' prefix that divides the batch (None: replicated)."""
    out, prod = [], 1
    for a in dp_axes(mesh):
        if batch_size % (prod * mesh.shape[a]) == 0:
            out.append(a)
            prod *= mesh.shape[a]
    return tuple(out) if out else None


def shard_shape(mesh: Mesh, shape: Sequence[int], spec: P) -> tuple:
    """One device's shard of a ``shape`` array laid out by ``spec`` on
    ``mesh`` (``jax.sharding.NamedSharding(mesh, spec).shard_shape``):
    each dim divided by the product of its axes' sizes, a dim past the
    spec's length whole.  Raises ValueError where that product does not
    divide the dim, or the spec is longer than the shape."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more dims than shape "
                         f"{tuple(shape)}")
    out = []
    for i, size in enumerate(shape):
        n = _axes_size(mesh, spec[i] if i < len(spec) else None)
        if size % n:
            raise ValueError(f"dim {i} of {tuple(shape)} ({size}) does not "
                             f"divide over {spec[i]!r} ({n} devices)")
        out.append(size // n)
    return tuple(out)


def with_hidden_sharding(mesh: Mesh, h, *, seq_parallel: bool = True):
    """The reference constrains hidden states ``[B, S, D]`` to batch over
    dp and sequence over ``model``; on one device that is ``h`` itself."""
    return h


def with_channel_sharding(mesh: Mesh, h):
    """The reference constrains ``[B, S, D]`` with D over ``model`` (the
    recurrent families' layout); on one device that is ``h`` itself."""
    return h


def kv_plane_spec(mesh: Mesh, n_planes: int, *, lead_dims: int = 1) -> P:
    """The spec of a plane-layout KV cache / pool ``[..., P, S, dh]``: the
    plane axis over the data axes (then ``model``) when they divide it,
    rows and ``dh`` replicated, ``lead_dims`` leading axes replicated."""
    plane = dim_spec(mesh, n_planes, ("data", "pod", "model"), "model")
    return P(*([None] * lead_dims), plane, None, None)


def page_table_spec(mesh: Mesh) -> P:
    """The page table ``[slots, max_pages]`` is replicated."""
    return P(None, None)


def named(mesh: Mesh, spec: P) -> P:
    """The reference's ``NamedSharding(mesh, spec)``; on one device there
    is nothing to place, and the spec is returned."""
    return spec


def tree_shardings(mesh: Mesh, spec_tree):
    """The reference maps `named` over a tree of specs; on one device the
    tree is returned as it is."""
    return spec_tree


__all__ = ["P", "dp_axes", "fsdp_axes", "dim_spec", "logical_spec",
           "shard_batch", "shard_shape", "with_hidden_sharding",
           "with_channel_sharding", "kv_plane_spec", "page_table_spec",
           "named", "tree_shardings"]
