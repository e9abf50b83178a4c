"""Device-side paged KV pool: plane-layout pages + gather/scatter views —
counterpart of `repro.serving.paged_kv`.

The pool generalizes the contiguous plane cache (``models/*.init_cache``:
``[L, B*KH, Smax, dh]``) by cutting the row axis into fixed-size pages:

    pool[k|v] : [L, num_pages * KH, page_size, dh]

Pool plane ``page * KH + h`` holds kv-head ``h``'s rows of one page — the
same plane-per-(owner, head) rule as the contiguous cache, with *page* as
the owner instead of *sequence*.  A request's logical position ``t`` lives
at page ``table[slot, t // page_size]``, row ``t % page_size``
(`serving.pages`).

A batch step never indexes pages inside the model.  Instead the engine

1. **gathers** each live slot's pages into a contiguous plane view
   ``[L, B*KH, V*page_size, dh]`` (a copy — bitwise identical to the
   cache a contiguous run would hold),
2. runs the unmodified ``bundle.decode_step`` on the view (which, with
   ``cache_update="scatter"``, writes its new rows into the view through
   the `kernels.kv_cache_update` kernel), and
3. **extracts** the rows the step wrote (``clen .. clen+C-1`` per
   sequence) and scatters exactly those back into the pool.

Copies and row moves are value-exact, so paged serving's logits are
*bitwise equal* to a contiguous-cache run of the same padded width.  A
contiguous cache is the degenerate configuration ``page_size == max_len``
(one page per request).

`paged_pool_specs` gives the reference's specs of the pool over a mesh
(`launch.mesh.Mesh` or `LiveMesh`).  On a live mesh (`init_pool` with
``mesh``) a rank holds only its block of the pool planes by them, and
the step's view is the rank's block of the view planes by the model's
``cache_specs``: a view plane is a copy of ``V`` pool planes that may lie
on any rank.  `gather_view_live` brings each rank the pool planes of its
view planes, `scatter_rows_live` takes each written row to every rank
that holds its pool plane, each in one ``all_to_all`` of copies
(`distributed.sharding.route` / `exchange`: a rank receives only the
planes and rows it lacks, never the whole pool); `extract_rows` stays
local.  The host-side indices are built alike on every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributed import sharding as shd
from .pages import NULL_PAGE, PageTable

Tensor = torch.Tensor


def init_pool(n_layers: int, num_pages: int, n_kv_heads: int,
              page_size: int, head_dim: int, dtype=torch.bfloat16,
              device=None, mesh=None) -> dict:
    """The zeroed pool; on a live ``mesh`` this rank's block of it by
    `paged_pool_specs` (`distributed.sharding.shard_shape`)."""
    shape = (n_layers, num_pages * n_kv_heads, page_size, head_dim)
    if mesh is not None:
        shape = shd.shard_shape(mesh, shape, paged_pool_specs(
            mesh, num_pages, n_kv_heads)["k"])
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Host-side index building (numpy; identical to the reference's)
# ---------------------------------------------------------------------------

def gather_planes(pt: PageTable, slots, kh: int, view_pages: int) -> np.ndarray:
    """``[B*KH, V]`` pool-plane ids backing each view plane's pages.

    ``slots`` may contain -1 entries (batch padding): they gather the null
    page.  View plane ``b*KH + h`` page ``j`` comes from pool plane
    ``table[slot_b, j] * KH + h``.
    """
    b = len(slots)
    pages = np.full((b, view_pages), NULL_PAGE, np.int32)
    for i, s in enumerate(slots):
        if s >= 0:
            pages[i] = pt.table[s, :view_pages]
    planes = pages[:, None, :] * kh \
        + np.arange(kh, dtype=np.int32)[None, :, None]
    return planes.reshape(b * kh, view_pages).astype(np.int32)


def scatter_indices(pt: PageTable, slots, clen, kh: int,
                    chunk: int) -> tuple[np.ndarray, np.ndarray]:
    """Pool (plane, row) targets for the ``chunk`` rows written at
    positions ``clen[i] .. clen[i]+chunk-1`` of each slot.

    Both arrays are ``[B*KH, chunk]``.  Padding slots (-1) and positions
    past a slot's mapped pages target the null page (harmless garbage).
    """
    b, ps = len(slots), pt.page_size
    planes = np.full((b, kh, chunk), NULL_PAGE * kh, np.int64)
    rows = np.zeros((b, kh, chunk), np.int64)
    for i, s in enumerate(slots):
        if s < 0:
            continue
        t = int(clen[i]) + np.arange(chunk)
        page = pt.table[s, t // ps]
        planes[i] = page[None, :] * kh + np.arange(kh)[:, None]
        rows[i] = np.broadcast_to(t % ps, (kh, chunk))
    return (planes.reshape(b * kh, chunk).astype(np.int32),
            rows.reshape(b * kh, chunk).astype(np.int32))


# ---------------------------------------------------------------------------
# Device-side view ops
# ---------------------------------------------------------------------------

def gather_view(pool_leaf: Tensor, planes: Tensor) -> Tensor:
    """``[L, P, ps, dh]`` pool + ``[Bkh, V]`` plane ids ->
    ``[L, Bkh, V*ps, dh]`` contiguous plane view (a copy)."""
    l, _, ps, dh = pool_leaf.shape
    bkh, v = planes.shape
    view = pool_leaf[:, planes.long()]               # [L, Bkh, V, ps, dh]
    return view.reshape(l, bkh, v * ps, dh)


def extract_rows(view_leaf: Tensor, clen_rep: Tensor, chunk: int) -> Tensor:
    """Rows ``clen_rep[p] .. +chunk-1`` of each view plane:
    ``[L, Bkh, W, dh]`` -> ``[L, Bkh, chunk, dh]``."""
    l, bkh, _, dh = view_leaf.shape
    rows = clen_rep.long()[:, None] + torch.arange(
        chunk, device=view_leaf.device)[None, :]                 # [Bkh, C]
    return view_leaf.gather(2, rows[None, :, :, None].expand(l, bkh, chunk,
                                                             dh))


def scatter_rows(pool_leaf: Tensor, rows_val: Tensor, planes: Tensor,
                 row_ids: Tensor) -> Tensor:
    """Write ``rows_val`` ``[L, Bkh, C, dh]`` at pool ``(planes, row_ids)``
    (both ``[Bkh, C]``), in place; returns ``pool_leaf``."""
    pool_leaf[:, planes.long(), row_ids.long()] = \
        rows_val.to(pool_leaf.dtype)
    return pool_leaf


# ---------------------------------------------------------------------------
# Live meshes: the view and the written rows between the ranks' blocks
# ---------------------------------------------------------------------------

def _plane_axes(mesh, n_planes: int) -> tuple:
    return shd.spec_axes(shd.kv_plane_spec(mesh, n_planes)[1])


def plane_block(mesh, n_planes: int) -> tuple:
    """``(start, size)`` of this rank's block of ``n_planes`` KV planes
    laid out by `sharding.kv_plane_spec`: the pool's (`paged_pool_specs`)
    or a view's (the model's ``cache_specs``)."""
    return shd.block_of(mesh, _plane_axes(mesh, n_planes), n_planes)


def gather_view_live(pool: dict, planes: np.ndarray, mesh,
                     n_pool_planes: int) -> dict:
    """This rank's block of the contiguous view ``[L, n, V*ps, dh]`` (its
    `plane_block` of the view planes) of the host-side pool-plane ids
    ``planes`` ``[B*KH, V]`` (`gather_planes`), from the ranks' pool
    blocks ``pool`` (`paged_pool_specs`): both leaves' planes in one
    exchange (`distributed.sharding.exchange`), a copy."""
    bkh, v = planes.shape
    wants = []
    for r in range(mesh.size):
        p0, n = shd.block_of(mesh, _plane_axes(mesh, bkh), bkh, r)
        wants.append(planes[p0:p0 + n].reshape(-1))
    rt = shd.route(mesh, _plane_axes(mesh, n_pool_planes), n_pool_planes,
                   wants)
    idx = torch.as_tensor(rt.send, device=pool["k"].device)
    items = torch.stack([pool[k][:, idx].transpose(0, 1)
                         for k in ("k", "v")], dim=1)   # [m, 2, L, ps, dh]
    got = shd.exchange(items, mesh, rt)                 # [n*V, 2, L, ps, dh]
    l, _, ps, dh = pool["k"].shape
    n = got.shape[0] // v
    got = got.reshape(n, v, 2, l, ps, dh).permute(2, 3, 0, 1, 4, 5)
    # contiguous: the kv kernel writes the view in place
    return {k: got[i].reshape(l, n, v * ps, dh).contiguous()
            for i, k in enumerate(("k", "v"))}


def scatter_rows_live(pool: dict, rows_val: dict, planes: np.ndarray,
                      row_ids: np.ndarray, mesh, n_pool_planes: int) -> dict:
    """Write the rows each rank took out of its view block (``rows_val``
    ``[L, n, C, dh]`` a leaf, `extract_rows` of its `plane_block`) at their
    pool ``(planes, row_ids)`` (host-side, both ``[B*KH, C]``:
    `scatter_indices`) in the pool block of every rank that holds the
    plane, in place: the rows cross ranks in one exchange
    (`distributed.sharding.exchange`) and land in the order one device
    writes them.  Returns ``pool``."""
    bkh, c = planes.shape
    l, _, _, dh = pool["k"].shape
    pax = _plane_axes(mesh, n_pool_planes)
    p0, m = plane_block(mesh, n_pool_planes)
    flat = planes.reshape(-1).astype(np.int64)
    wants = [np.flatnonzero(flat // m == mesh.index(pax, r))
             for r in range(mesh.size)]
    rt = shd.route(mesh, _plane_axes(mesh, bkh), bkh * c, wants)
    idx = torch.as_tensor(rt.send, device=pool["k"].device)
    items = torch.stack([rows_val[k].permute(1, 2, 0, 3).reshape(-1, l, dh)
                         [idx] for k in ("k", "v")], dim=1)  # [s, 2, L, dh]
    got = shd.exchange(items, mesh, rt)                 # [w, 2, L, dh]
    mine = wants[mesh.rank]
    dev = pool["k"].device
    tp = torch.as_tensor(flat[mine] - p0, device=dev)
    tr = torch.as_tensor(row_ids.reshape(-1)[mine].astype(np.int64),
                         device=dev)
    for i, k in enumerate(("k", "v")):
        pool[k][:, tp, tr] = got[:, i].transpose(0, 1).to(pool[k].dtype)
    return pool


def paged_pool_specs(mesh, num_pages: int, n_kv_heads: int) -> dict:
    """The pool leaves' specs: planes over the dp axes, then ``model``
    (`distributed.sharding.kv_plane_spec`, one leading L dim); the page
    table stays host-side (`sharding.page_table_spec` if mirrored)."""
    spec = shd.kv_plane_spec(mesh, num_pages * n_kv_heads, lead_dims=1)
    return {"k": spec, "v": spec}
