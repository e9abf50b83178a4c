"""Sharding rules — counterpart of `repro.distributed.sharding`, over the
port's `launch.mesh.Mesh` (a description) and `launch.mesh.LiveMesh` (live
`torch.distributed` ranks).

The reference maps its production mesh ``(data, model)`` (or ``(pod,
data, model)``) onto every parameter and activation:

* ``model`` — tensor parallel: attention heads, d_ff columns, vocab rows,
  MoE experts;
* ``data``  — batch data-parallel and FSDP: the non-TP dim of every large
  parameter;
* ``pod``   — pure data parallel, composed with ``data`` for the batch.

Every rule is divisibility-guarded: a dim is sharded over an axis only if
the axis size divides it.  The rules decide the same specs (tuples of
axis names, `P`) as the reference's on any mesh; `shard_shape` turns a
decision into one device's shard, which the dry run's production-mesh
records sum into per-device bytes.

On a live mesh the decisions are carried out: `place` cuts a rank's block
of a whole tensor, `gather` reassembles blocks over named axes
(``all_gather``), `all_reduce` sums over named axes, `planes_of` /
`rows_of` move an activation between the batch-row layout and the
cache's plane layout, `route` / `exchange` bring each rank the items of
other ranks' blocks it wants (one ``all_to_all`` of copies: the paged KV
pool's pages and written rows), and `named` / `tree_shardings` give
placements.  A
dim split over a tuple of axes is split first axis major, as the
reference splits it.  Every collective ticks `COLLECTIVES` (per kind, its
ops and operand bytes: the counterpart of the reference's
``hlo_cost.analyze(...).coll``); a collective over axes that hold one
rank is skipped and not counted.  On a description `named`,
`tree_shardings`, `with_hidden_sharding` and `with_channel_sharding`
return what they are given.

Autograd goes through the collectives, each backward the exact adjoint
of its forward: `gather` / `gather_tree` (``all_gather``) <->
`reduce_scatter_tree` (``reduce_scatter``: each block the float32 sum of
the group's gradients of it), `all_reduce` (a sum) <-> the same sum, and
a cut to this rank's block (``narrow``) <-> the zero-padded block, which
the sums further back add up to the gather of the blocks.  `cols`,
`project`, `sum_in_order`, `embed_rows` and `vocab_logits` are built of
these and are differentiable through them.  The convention of a sharded
loss: the global loss is the sum of the ranks' local losses, each rank
seeding its own backward with 1; work that several ranks repeat on the
same rows enters each rank's loss divided by its replication count
(powers of two: the split is exact).  A rank's gradient of a block is
then the global loss's gradient of it once the gathers' reduce-scatters
have run and `reduce_replicated` has summed it over the axes its spec
leaves it replicated on.  Without grad (serving) the same functions run
their forward only and record no graph.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..launch.mesh import LiveMesh, Mesh, spec_axes

Tensor = torch.Tensor


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
    dp and sequence over ``model``; the port's live path keeps a rank's
    batch rows whole (`models.transformer`), so this is ``h`` itself."""
    return h


def with_channel_sharding(mesh: Mesh, h):
    """The reference constrains the recurrent families' hidden states
    ``[B, S, D]`` with D over ``model`` between layers, a layout choice
    that leaves the values as they are.  On the port's live mesh the
    channel split happens inside each layer instead: the time mix's
    r / k / v / g and the Mamba mixer's z / x / dt come out of their
    projections split over ``model`` by heads (`cols` to the heads of
    the state's spec), the recurrence and its norm run on the rank's
    heads, and the out-projection is row-parallel over ``model``
    (`models.rwkv6`, `models.zamba2`), so the residual between layers is
    the rank's batch rows with D whole and this is ``h`` itself."""
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


@dataclasses.dataclass(frozen=True)
class Placement:
    """The reference's ``NamedSharding(mesh, spec)`` on a live mesh."""
    mesh: LiveMesh
    spec: P

    def place(self, t: Tensor) -> Tensor:
        return place(t, self.mesh, self.spec)


def named(mesh, spec: P):
    """The reference's ``NamedSharding(mesh, spec)``: a `Placement` on a
    live mesh; on a description, nothing is placed and the spec is
    returned."""
    return Placement(mesh, spec) if isinstance(mesh, LiveMesh) else spec


def tree_shardings(mesh, spec_tree):
    """`named` over a dict tree of specs (a spec is a leaf); on a
    description, the tree itself."""
    if not isinstance(mesh, LiveMesh):
        return spec_tree
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(mesh, v) for k, v in spec_tree.items()}
    return named(mesh, spec_tree)


def place_tree(tree, shardings):
    """Each tensor of a dict tree cut to its `Placement`'s block (the
    reference's ``device_put(tree, shardings)``); a leaf whose sharding is
    a bare spec (a description) is kept whole."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    return shardings.place(tree) if isinstance(shardings, Placement) \
        else tree


# ---------------------------------------------------------------------------
# Live meshes: blocks and collectives
# ---------------------------------------------------------------------------

class CollectiveCounter:
    """Collectives run, per kind: ``{kind: {"ops": n, "bytes": b}}``, the
    bytes each rank's operand holds (a gather's shard, a sum's tensor)."""

    def __init__(self):
        self._counts: "collections.defaultdict" = collections.defaultdict(
            collections.Counter)

    def record(self, kind: str, nbytes: int) -> None:
        self._counts[kind]["ops"] += 1
        self._counts[kind]["bytes"] += int(nbytes)

    def reset(self) -> None:
        self._counts.clear()

    def snapshot(self) -> dict:
        return {k: dict(c) for k, c in sorted(self._counts.items())}


COLLECTIVES = CollectiveCounter()


def _group(mesh: LiveMesh, axes):
    """The process group over ``axes``; None where they hold one rank."""
    group = mesh.group(axes)
    if group is None and _axes_size(mesh, tuple(spec_axes(axes))) > 1:
        raise RuntimeError(f"the mesh has no process group over {axes!r}")
    return group


def block_of(mesh: LiveMesh, axes, extent: int, rank: int | None = None):
    """``(start, size)`` of ``rank``'s block of a dim of ``extent`` split
    over ``axes``."""
    n = _axes_size(mesh, axes or None)
    if extent % n:
        raise ValueError(f"{extent} does not divide over {axes!r} ({n})")
    size = extent // n
    return (mesh.index(axes, rank) * size if axes else 0), size


def place(t: Tensor, mesh: LiveMesh, spec: P) -> Tensor:
    """This rank's block of the whole tensor ``t`` laid out by ``spec``,
    a copy (so ``t`` can be freed); its shape is `shard_shape`'s."""
    shard_shape(mesh, tuple(t.shape), spec)       # raises where it cannot
    for i, d in enumerate(spec):
        if d is not None:
            start, size = block_of(mesh, d, t.shape[i])
            t = t.narrow(i, start, size)
    return t.clone(memory_format=torch.contiguous_format)


def _bytes_of(t: Tensor) -> Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _cuts(tensors: dict, specs: dict, axes: set) -> dict:
    """``{key: the axes of ``axes`` its spec splits it over}`` for every
    tensor its spec splits over one of ``axes``; a dim split over ``axes``
    and other axes at once raises."""
    todo = {}
    for k in tensors:
        spec = specs[k]
        cut = set()
        for d in spec:
            names = set(spec_axes(d))
            if names & axes and not names <= axes:
                raise ValueError(f"{k}: spec {spec!r} splits one dim over "
                                 f"gathered and kept axes ({sorted(axes)})")
            cut |= names & axes
        if cut:
            todo[k] = frozenset(cut)
    return todo


def _over(mesh: LiveMesh, cuts) -> tuple:
    """The mesh's axes that any of the ``cuts`` names, in mesh order."""
    return tuple(a for a in mesh.axis_names if any(a in c for c in cuts))


def _gather_raw(shards: list, mesh: LiveMesh, specs: list, cuts: list,
                over: tuple, group) -> list:
    """The all_gather of `gather_tree` (see there) on the shards that a
    cut splits."""
    sizes, offsets, parts, off = [], [], [], 0
    for t in shards:
        b = _bytes_of(t)
        sizes.append(b.numel())
        offsets.append(off)
        parts += [b, b.new_zeros(-b.numel() % 16)]
        off += b.numel() + parts[-1].numel()
    buf = torch.cat(parts)
    ranks = mesh.group_ranks(over)
    pieces = [torch.empty_like(buf) for _ in ranks]
    torch.distributed.all_gather(pieces, buf, group=group)
    COLLECTIVES.record("all_gather", sum(sizes))
    mine = mesh.coord()
    out = []
    for t, spec, cut, off, size in zip(shards, specs, cuts, offsets, sizes):
        full = list(t.shape)
        for i, d in enumerate(spec):
            if set(spec_axes(d)) & cut:
                full[i] *= _axes_size(mesh, d)
        res = t.new_empty(full)
        for r, piece in zip(ranks, pieces):
            c = mesh.coord(r)
            # a rank that differs only on axes this leaf is whole over
            # holds the same block: take it from the rank on our coord
            if any(c[a] != mine[a] for a in over if a not in cut):
                continue
            blk = piece[off:off + size].view(t.dtype).reshape(t.shape)
            view = res
            for i, d in enumerate(spec):
                if set(spec_axes(d)) & cut:
                    view = view.narrow(i, mesh.index(d, r) * t.shape[i],
                                       t.shape[i])
            view.copy_(blk)
        out.append(res)
    return out


def _cast(t: Tensor, dtype) -> Tensor:
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


class _GatherTree(torch.autograd.Function):
    """`gather_tree`'s cast and all_gather; its backward is the adjoint,
    the reduce-scatter of the gradients onto the blocks
    (`reduce_scatter_tree`: each block the float32 sum of the group's
    gradients of it, returned in the shard's own dtype)."""

    @staticmethod
    def forward(ctx, mesh, specs, cuts, over, group, dtype, *shards):
        ctx.mesh, ctx.specs, ctx.cuts = mesh, specs, cuts
        ctx.dtypes = [t.dtype for t in shards]
        return tuple(_gather_raw([_cast(t, dtype) for t in shards], mesh,
                                 specs, cuts, over, group))

    @staticmethod
    def backward(ctx, *grads):
        keys = range(len(grads))
        out = reduce_scatter_tree(dict(zip(keys, grads)), ctx.mesh,
                                  dict(zip(keys, ctx.specs)),
                                  dict(zip(keys, ctx.cuts)),
                                  dict(zip(keys, ctx.dtypes)))
        return (None,) * 6 + tuple(out[k] for k in keys)


def gather_tree(shards: dict, mesh: LiveMesh, specs: dict, axes,
                dtype: torch.dtype | None = None) -> dict:
    """`gather` of several shards in one collective: every shard whose
    spec splits a dim over one of ``axes`` is reassembled over those
    axes (a floating one cast to ``dtype`` first, where given); the
    others are returned as they are.  The shards travel as one byte
    buffer (each padded to 16 bytes), so leaves of any dtypes share the
    ``all_gather``; `COLLECTIVES` counts their bytes unpadded.  Under
    autograd the backward is the reduce-scatter of the gradients
    (`reduce_scatter_tree`), each returned in its shard's own dtype: the
    float32 sum of a bf16 use of a float32 weight is not rounded to
    bf16."""
    todo = _cuts(shards, specs, set(spec_axes(axes)))
    out = dict(shards)
    if not todo:
        return out
    keys = list(todo)
    over = _over(mesh, todo.values())
    group = _group(mesh, over)
    if group is None:
        out.update((k, _cast(shards[k], dtype)) for k in keys)
        return out
    got = _GatherTree.apply(mesh, [specs[k] for k in keys],
                            [todo[k] for k in keys], over, group, dtype,
                            *(shards[k] for k in keys))
    out.update(zip(keys, got))
    return out


def gather(shard: Tensor, mesh: LiveMesh, spec: P, axes=None) -> Tensor:
    """The blocks of ``shard`` (laid out by ``spec``) reassembled over
    ``axes`` (default: every axis the spec names) by one ``all_gather``:
    the dims split over them come back whole, in the order `place` cut
    them.  A dim split over gathered and kept axes raises."""
    if axes is None:
        axes = tuple(a for d in spec for a in spec_axes(d))
    return gather_tree({"x": shard}, mesh, {"x": spec}, axes)["x"]


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum over ranks is taken in: float32, float64 for
    float64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def reduce_scatter_tree(wholes: dict, mesh: LiveMesh, specs: dict,
                        cuts: dict, dtypes: dict | None = None) -> dict:
    """The adjoint of `gather_tree`: each tensor of ``wholes`` with an
    entry in ``cuts`` (the axes its spec splits it over that a gather
    made whole) is whole over those axes on every rank; it comes back as
    this rank's block of its sum over the ranks of those axes (the rest
    are returned as they are).  The sums are taken in float32 (float64
    for float64) and returned in each tensor's dtype (its entry of
    ``dtypes``, where given).  Tensors cut over the same axes share one
    ``reduce_scatter``; `COLLECTIVES` counts each rank's operand bytes
    (the whole tensors in float32)."""
    dtypes = dtypes or {}
    out = dict(wholes)
    for cut in dict.fromkeys(cuts.values()):
        keys = [k for k, c in cuts.items() if c == cut]
        over = _over(mesh, [cut])
        group = _group(mesh, over)
        if group is None:
            out.update((k, wholes[k].to(dtypes.get(k, wholes[k].dtype)))
                       for k in keys)
            continue
        wide = torch.float64 if any(wholes[k].dtype == torch.float64
                                    for k in keys) else torch.float32

        def block(t, spec, r):
            for i, d in enumerate(spec):
                if set(spec_axes(d)) & cut:
                    n = t.shape[i] // _axes_size(mesh, d)
                    t = t.narrow(i, mesh.index(d, r) * n, n)
            return t
        ranks = mesh.group_ranks(over)
        ins = [torch.cat([block(wholes[k], specs[k], r).reshape(-1).to(wide)
                          for k in keys]) for r in ranks]
        got = torch.empty_like(ins[ranks.index(mesh.rank)])
        torch.distributed.reduce_scatter(got, ins, group=group)
        COLLECTIVES.record("reduce_scatter",
                           sum(x.numel() for x in ins) * got.element_size())
        off = 0
        for k in keys:
            shape = block(wholes[k], specs[k], mesh.rank).shape
            n = math.prod(shape)
            out[k] = got[off:off + n].reshape(shape).to(
                dtypes.get(k, wholes[k].dtype))
            off += n
    return out


def _all_reduce_raw(t: Tensor, group) -> Tensor:
    # a copy: the sum is taken in place, and ``t`` may be a gradient
    # another branch of the graph reads too
    x = t.to(_wide(t.dtype), copy=True) if t.is_floating_point() \
        else t.clone()
    torch.distributed.all_reduce(x, group=group)
    COLLECTIVES.record("all_reduce", x.numel() * x.element_size())
    return x.to(t.dtype)


class _AllReduce(torch.autograd.Function):
    """A sum over ranks; its adjoint is the same sum of the gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce_raw(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.group), None


def all_reduce(t: Tensor, mesh: LiveMesh, axes) -> Tensor:
    """The sum of ``t`` over the ranks of ``axes`` (one ``all_reduce``),
    taken in float32 (float64 for a float64 ``t``) and returned in ``t``'s
    dtype, so the ranks hold the same result whatever the backend sums a
    narrower float in.  Under autograd the backward is the same sum of
    the gradients."""
    group = _group(mesh, axes)
    if group is None:
        return t
    return _AllReduce.apply(t, group)


def replicated_axes(mesh: LiveMesh, spec: P) -> tuple:
    """The mesh's axes of more than one rank that ``spec`` names in no
    dim: the ranks along them hold the same block."""
    named = {a for d in spec for a in spec_axes(d)}
    return tuple(a for a in mesh.axis_names
                 if a not in named and mesh.shape[a] > 1)


def reduce_replicated(grads, mesh: LiveMesh, specs):
    """The gradient blocks of the global loss from each rank's gradients
    of its own loss (the convention of `models.transformer._build_live`'s
    ``train_loss``): each leaf's block summed over the axes its spec
    leaves it replicated on (`replicated_axes`, one ``all_reduce`` a leaf
    that has any), the blocks the gathers' reduce-scatters made already
    summed over the axes that split the leaf."""
    if isinstance(grads, dict):
        return {k: reduce_replicated(v, mesh, specs[k])
                for k, v in grads.items()}
    axes = replicated_axes(mesh, specs)
    return all_reduce(grads, mesh, axes) if axes else grads


# ---------------------------------------------------------------------------
# Live meshes: a copy-exact exchange of items between blocks
# ---------------------------------------------------------------------------
#
# Items (pool planes, cache rows) lie along a dim of ``extent`` split over
# ``axes``; each rank wants some of them, in an order of its own, and the
# wants of every rank are known on every rank (they follow from host-side
# indices that every rank builds alike).  A wanted item comes from the
# rank that holds its block and agrees with the wanting rank on every
# other axis (the rank itself where it holds the block), so one
# ``all_to_all`` carries each item once to each rank that wants it.  It
# moves bytes: copies, never sums (a sum with zeros would turn -0.0 into
# +0.0).

@dataclasses.dataclass(frozen=True)
class Route:
    """This rank's part of one exchange (`route`): ``send`` the local
    indices it sends, to rank 0 first, ``send_counts`` / ``recv_counts``
    the items it sends to / takes from each rank, ``order`` the position
    in the received items of each item it wants (its want order), and
    ``moves`` whether any item crosses ranks anywhere on the mesh (the
    same on every rank: where it is False nobody calls the collective)."""
    send: np.ndarray
    send_counts: tuple
    recv_counts: tuple
    order: np.ndarray
    moves: bool


def _source_ranks(mesh: LiveMesh, axes: tuple, extent: int, ids,
                  dst: int) -> np.ndarray:
    """The rank each of ``ids`` (items of a dim of ``extent`` split over
    ``axes``) comes from for rank ``dst``: the holder of its block whose
    coordinates on the other axes are ``dst``'s."""
    block = extent // _axes_size(mesh, axes or None)
    idx = np.asarray(ids, np.int64) // block
    coord = {a: np.full(idx.shape, c, np.int64)
             for a, c in mesh.coord(dst).items()}
    for a in reversed(axes):          # the first axis is the major one
        coord[a] = idx % mesh.shape[a]
        idx = idx // mesh.shape[a]
    rank = np.zeros(idx.shape, np.int64)
    for a in mesh.axis_names:
        rank = rank * mesh.shape[a] + coord[a]
    return rank


def route(mesh: LiveMesh, axes, extent: int, wants: list) -> Route:
    """This rank's `Route` of the exchange in which rank ``r`` wants the
    items ``wants[r]`` (ids along a dim of ``extent`` laid out over
    ``axes``, in the order it wants them); host-side numpy, the same
    decisions on every rank."""
    axes = tuple(spec_axes(axes))
    me = mesh.rank
    start, _ = block_of(mesh, axes, extent)
    sends, send_counts, moves, mine = [], [], False, None
    for dst in range(mesh.size):
        ids = np.asarray(wants[dst], np.int64)
        src = _source_ranks(mesh, axes, extent, ids, dst)
        moves = moves or bool((src != dst).any())
        sel = ids[src == me] - start
        sends.append(sel)
        send_counts.append(len(sel))
        if dst == me:
            mine = src
    # the received items lie by source rank, each source's in want order
    by_src = np.argsort(mine, kind="stable")
    order = np.empty_like(by_src)
    order[by_src] = np.arange(len(by_src))
    recv_counts = tuple(int((mine == s).sum()) for s in range(mesh.size))
    return Route(np.concatenate(sends) if sends else np.zeros(0, np.int64),
                 tuple(send_counts), recv_counts, order, moves)


def exchange(items: Tensor, mesh: LiveMesh, rt: Route) -> Tensor:
    """The items this rank wants, in its want order, of the exchange
    ``rt`` (`route`); ``items`` ``[n, ...]`` are the ones it sends
    (``items[i]`` the item of local index ``rt.send[i]``).  One
    ``all_to_all`` of the items' bytes over every rank (skipped where no
    item crosses ranks); `COLLECTIVES` counts the bytes this rank sends
    to other ranks."""
    flat = items.contiguous().reshape(items.shape[0],
                                      math.prod(items.shape[1:]))
    raw = flat.view(torch.uint8)
    if not rt.moves:
        got = raw
    else:
        got = raw.new_empty((sum(rt.recv_counts), raw.shape[1]))
        torch.distributed.all_to_all_single(
            got, raw, output_split_sizes=list(rt.recv_counts),
            input_split_sizes=list(rt.send_counts))
        out = sum(n for r, n in enumerate(rt.send_counts) if r != mesh.rank)
        COLLECTIVES.record("all_to_all", out * raw.shape[1])
    order = torch.as_tensor(rt.order, device=items.device)
    return got[order].view(items.dtype).reshape(len(rt.order),
                                                *items.shape[1:])


# ---------------------------------------------------------------------------
# Live meshes: batch rows <-> KV planes
# ---------------------------------------------------------------------------
#
# An activation ``[B, S, C]`` (C = kh * w: kh heads, or head groups, of w
# columns) lies on the mesh in a row layout ``(bax, cax)``: rows split
# over the axes ``bax``, columns over ``cax``.  The KV cache's plane
# layout puts plane ``p = b * kh + h`` (row b, head h) on the rank whose
# block of the ``[B*kh]`` plane dim over ``pax`` holds it.  A rank keeps
# the planes it holds rows for in place; where any rank lacks a row or a
# head of its planes, the activation is first gathered whole (one
# collective; every rank takes the same branch, decided from the mesh's
# shape alone).

def _row_block(mesh, layout, b: int, c: int, rank):
    bax, cax = layout
    r0, bl = block_of(mesh, bax, b, rank)
    c0, cl = block_of(mesh, cax, c, rank)
    return r0, bl, c0, cl


def _holds_planes(mesh, layout, b, c, kh, pax, rank) -> bool:
    """Does ``rank``'s row block hold every (row, head) of its planes?"""
    w = c // kh
    r0, bl, c0, cl = _row_block(mesh, layout, b, c, rank)
    p0, n = block_of(mesh, pax, b * kh, rank)
    ra, rb = p0 // kh, (p0 + n - 1) // kh
    if c0 % w or cl % w or ra < r0 or rb >= r0 + bl:
        return False
    h0, nh = c0 // w, cl // w
    if ra != rb:
        return nh == kh
    return h0 <= p0 % kh and (p0 + n - 1) % kh < h0 + nh


def planes_of(x: Tensor, mesh: LiveMesh, layout, kh: int, pax) -> Tensor:
    """This rank's KV planes ``[n, S, w]`` of the activation whose row
    block ``[bl, S, cl]`` is ``x`` (`layout` ``(bax, cax)``)."""
    bax, cax = layout
    b = x.shape[0] * _axes_size(mesh, bax or None)
    c = x.shape[2] * _axes_size(mesh, cax or None)
    if not all(_holds_planes(mesh, layout, b, c, kh, pax, r)
               for r in range(mesh.size)):
        x = gather(x, mesh, P(bax or None, None, cax or None))
        layout = ((), ())
    r0, bl, c0, cl = _row_block(mesh, layout, b, c, None)
    w = c // kh
    p0, n = block_of(mesh, pax, b * kh)
    p = torch.arange(p0, p0 + n, device=x.device)
    heads = x.reshape(x.shape[0], x.shape[1], -1, w)
    return heads[p // kh - r0, :, p % kh - c0 // w]


def _holds_rows(mesh, layout, b, c, kh, pax, rank) -> bool:
    """Do ``rank``'s planes hold every (row, head) of its row block?"""
    w = c // kh
    r0, bl, c0, cl = _row_block(mesh, layout, b, c, rank)
    p0, n = block_of(mesh, pax, b * kh, rank)
    if c0 % w or cl % w:
        return False
    first = r0 * kh + c0 // w
    last = (r0 + bl - 1) * kh + (c0 + cl) // w - 1
    return p0 <= first and last < p0 + n


def rows_of(planes: Tensor, mesh: LiveMesh, pax, kh: int,
            layout) -> Tensor:
    """The row block ``[bl, S, cl]`` (`layout` ``(bax, cax)``) of the
    activation whose planes ``[n, S, w]`` this rank holds: the inverse of
    `planes_of`."""
    n, s, w = planes.shape
    b = n * _axes_size(mesh, pax or None) // kh
    c = kh * w
    if all(_holds_rows(mesh, layout, b, c, kh, pax, r)
           for r in range(mesh.size)):
        p0 = block_of(mesh, pax, b * kh)[0]
    else:
        planes = gather(planes, mesh, P(pax or None, None, None))
        p0 = 0
    r0, bl, c0, cl = _row_block(mesh, layout, b, c, None)
    h0, h1 = c0 // w, -(-(c0 + cl) // w)        # the heads the block cuts
    rows = torch.arange(r0, r0 + bl, device=planes.device)
    heads = torch.arange(h0, h1, device=planes.device)
    idx = rows[:, None] * kh + heads[None, :] - p0          # [bl, nh]
    out = planes[idx].transpose(1, 2).reshape(bl, s, (h1 - h0) * w)
    return out[..., c0 - h0 * w:c0 - h0 * w + cl]


# ---------------------------------------------------------------------------
# Live meshes: the parts of the serve program every family shares
# ---------------------------------------------------------------------------

def use_spec(spec: P, *, stacked: bool = True) -> P:
    """A param's use-time spec: its placed ``spec`` without the stacked
    L dim (``stacked``) and without the data / pod (FSDP) axes; ``model``
    is kept."""
    def clean(d):
        kept = tuple(n for n in spec_axes(d) if n == "model")
        return kept[0] if len(kept) == 1 else (kept or None)
    dims = list(spec)[1:] if stacked else list(spec)
    return P(*[clean(d) for d in dims])


def gather_for_use(mesh, lp: dict, placed: dict, use: dict,
                   dtype: torch.dtype) -> dict:
    """ZeRO-3 style per-layer weight materialization: on a live mesh each
    of the layer's placed weights ``lp`` (laid out by ``placed``) that is
    split over an axis its use-time spec ``use`` drops is cast to
    ``dtype`` *then* gathered over those axes (one ``all_gather`` for the
    layer, half the bytes of a float32 one at bf16); dims split over
    ``model`` stay split, and a weight that is not gathered keeps its
    dtype.  Under autograd the gradients flow back as one reduce-scatter
    onto the blocks (the ZeRO grad flow), in the blocks' dtype.  On a
    description or no mesh the layer is returned as it is."""
    if not isinstance(mesh, LiveMesh):
        return lp
    axes = {a for k in lp for d in placed[k] for a in spec_axes(d)} \
        - {a for k in lp for d in use[k] for a in spec_axes(d)}
    return gather_tree(lp, mesh, {k: placed[k] for k in lp}, axes, dtype)


def cols(mesh: LiveMesh, x: Tensor, have: tuple, want: tuple) -> Tensor:
    """``x`` with its last dim re-laid from a split over the axes ``have``
    to one over ``want`` (``()``: whole): gathered where ``have`` splits
    it, then cut to this rank's block of ``want``."""
    if tuple(have) == tuple(want):
        return x
    if have:
        x = gather(x, mesh, P(*([None] * (x.dim() - 1)), tuple(have)))
    if want:
        start, size = block_of(mesh, want, x.shape[-1])
        x = x.narrow(-1, start, size)
    return x


def project(mesh: LiveMesh, x: Tensor, have: tuple, w: Tensor | None,
            use: P, plan_layer=None, dtype: torch.dtype | None = None,
            exact: bool = False) -> tuple:
    """``(x @ W, the axes its columns are split over)`` for ``x`` whose
    columns are split over ``have``.  A planned projection (``plan_layer``,
    an `engine.plan.LayerPlan`) gathers its encoding and runs whole
    (`engine.execute.apply_fc`) on whole columns of ``x``.  A dense
    weight ``w`` (rounded to ``dtype``) runs at its use-time spec ``use``
    ``(in, out)``: column-parallel over the axes of ``out``, or
    row-parallel over those of ``in``, with one ``all_reduce`` of the
    float32 partial products (rounded to ``dtype`` once, after the sum, as
    one device rounds its product).  ``exact`` takes the products and the
    sum in float64 (`models.layers.matmul_f64`'s rule); a float64 ``w``
    holds values already rounded to ``dtype`` and is used as it is."""
    dtype = dtype or x.dtype
    if plan_layer is not None:
        from ..engine.execute import apply_fc
        return apply_fc(cols(mesh, x, have, ()), plan_layer).to(dtype), ()
    w_in, w_out = (spec_axes(d) for d in use)
    x = cols(mesh, x, have, w_in)
    wide = torch.float64 if exact else torch.float32
    w = w if w.dtype == torch.float64 else w.to(dtype)
    if not w_in:                                    # column-parallel
        if exact:
            return (x.double() @ w.double()).to(dtype), w_out
        return x @ w, w_out
    y = all_reduce(x.to(wide) @ w.to(wide), mesh, w_in)
    return y.to(dtype), w_out


def sum_in_order(t: Tensor, mesh: LiveMesh, axes) -> Tensor:
    """The sum of ``t`` over the ranks of ``axes`` in ``t``'s dtype, taken
    in the order of the ranks' blocks (one ``all_gather``), so that every
    rank holds the same bits whatever order a backend's ``all_reduce``
    adds in (a float64 row statistic keeps its precision)."""
    axes = tuple(a for a in mesh.axis_names if a in spec_axes(axes))
    if _axes_size(mesh, axes or None) == 1:
        return t
    return gather(t[None], mesh, P(axes)).sum(dim=0)


def embed_rows(mesh: LiveMesh, embed: Tensor, spec: P, tokens: Tensor,
               d_model: int, rows: slice) -> Tensor:
    """The float32 embedding rows ``[bl, s, d]`` of ``tokens[rows]`` from
    this rank's block ``embed`` of the ``[V, d]`` embedding laid out by
    ``spec`` (vocab over ``model`` where it divides, ``d`` over the FSDP
    axes): a masked local lookup of every row of ``tokens`` ``[B, s]``
    (the tokens outside the rank's vocab block look up zeros) into the
    rank's ``d`` block, summed by one ``all_reduce`` over the axes the
    spec names.  A vocab that ``model`` does not divide is replicated
    (``spec``'s first dim None): every rank looks every token up."""
    v_ax, d_ax = (spec_axes(d) for d in spec)
    v0 = mesh.index(v_ax) * embed.shape[0] if v_ax else 0
    vl = embed.shape[0]
    d0, dl = block_of(mesh, d_ax, d_model)
    t = tokens.long() - v0
    hit = (t >= 0) & (t < vl)
    emb = torch.zeros((*tokens.shape, d_model), dtype=torch.float32,
                      device=embed.device)
    emb[..., d0:d0 + dl] = torch.where(
        hit[..., None], embed[t.clamp(0, vl - 1)].float(), 0.0)
    axes = tuple(a for a in mesh.axis_names if a in v_ax + d_ax)
    return all_reduce(emb, mesh, axes)[rows]


def vocab_logits(mesh: LiveMesh, last: Tensor, embed: Tensor, spec: P,
                 bax: tuple, vocab: int) -> Tensor:
    """The whole batch's float32 logits ``[B, V]`` of the normed last
    positions ``last`` ``[bl, d]`` (this rank's rows of the batch split
    over ``bax``) against the embedding block ``embed`` laid out by
    ``spec``: the rows gathered over ``bax``, each rank's vocab and ``d``
    block's partial product, summed by one ``all_reduce``."""
    v_ax, d_ax = (spec_axes(d) for d in spec)
    v0, vl = block_of(mesh, v_ax, vocab)
    d0, dl = block_of(mesh, d_ax, last.shape[-1])
    last = last.float()
    if bax:
        last = gather(last, mesh, P(tuple(bax), None))
    logits = torch.zeros((last.shape[0], vocab), dtype=torch.float32,
                         device=last.device)
    logits[:, v0:v0 + vl] = last[:, d0:d0 + dl] @ embed.float().T
    axes = tuple(a for a in mesh.axis_names if a in v_ax + d_ax)
    return all_reduce(logits, mesh, axes)


__all__ = ["P", "dp_axes", "fsdp_axes", "dim_spec", "logical_spec",
           "shard_batch", "shard_shape", "with_hidden_sharding",
           "with_channel_sharding", "kv_plane_spec", "page_table_spec",
           "named", "tree_shardings", "Placement", "place_tree",
           "place", "gather", "gather_tree", "all_reduce", "planes_of",
           "reduce_scatter_tree", "replicated_axes", "reduce_replicated",
           "rows_of", "block_of", "spec_axes", "COLLECTIVES",
           "CollectiveCounter", "use_spec", "gather_for_use", "cols",
           "project", "sum_in_order", "embed_rows", "vocab_logits",
           "Route", "route", "exchange"]
