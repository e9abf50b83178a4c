"""Public wrappers around the kernels — counterpart of `repro.kernels.ops`.

Responsibilities: tile-alignment padding, the static block-size model
(`choose_blocks`, the reference's formula bit for bit, because ``bn`` and
KB are baked into the encodings a plan stores), skinny-M routing, the
differentiable pre-encoded entries `tiled_spmm` and (MoE experts, one
launch over the expert grid) `tiled_spmm_batched`, and the flat-format
eager fallbacks `balanced_spmm` / `balanced_spmm_batched`:

* ``impl="cuda"``       — the hand-written tile-local decode-and-matmul
                          kernels (`balanced_spmm`); skinny M (<= `SKINNY_M`)
                          routes to the decode kernel, a block-quantized
                          encoding to the quant kernels.  CPU tensors run
                          the kernels' plain version.  The flat
                          `balanced_spmm` takes this rung too, its weight
                          encoded at `choose_blocks`' bn behind a
                          per-weight cache (`_encode_cached`).
* ``impl="xla"``        — eager densify (gather-only, per-row searchsorted
                          into the ascending indices) + one matmul; skinny M
                          takes the gather formulation.
* ``impl="xla_gather"`` — gather + rank-3 reduction (``[M, O, K]`` buffer).

`bitmap_spmm` runs the bitmap-compressed format (`bitmap_spmm` module):
``cuda`` the hand-written kernel, ``xla`` the densify + matmul oracle.

A tiled encoding on an eager rung (a quantized plan keeps the tiled format
on every sparse rung, for its scales) runs the tiled twins: gather +
reduction with the block scale factored out of the slot sum up to
`GATHER_M` rows, a gather-only dequantizing densify + matmul above.

The impl names keep the reference's ladder; the hand-kernel rung is named
after its backend (``cuda``, the reference's ``pallas``).  Flat-format
indices must be ascending within each row.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import weakref

import torch
import torch.nn.functional as F

from . import ref
from .balanced_spmm import (tiled_balanced_spmm, tiled_balanced_spmm_batched,
                            tiled_balanced_spmm_skinny)
from .bitmap_spmm import bitmap_encode
from .bitmap_spmm import bitmap_spmm as bitmap_spmm_kernel
from .tile_format import (TiledBalanced, dequantize_values, encode_tiled,
                          leaf_perm, max_block_count, tiled_to_dense,
                          unpack_int4)

Tensor = torch.Tensor

# M at or below which the decode-specialized paths dispatch (the padded
# decode batch; a decode step's GEMM M is the batch).
SKINNY_M = 8

# Widest M at which the tiled eager rungs still take the gather + reduction
# over the densify + matmul (the reference's measured crossover).
GATHER_M = 32

# Stored bytes per weight slot under block quantization (None: the
# activation itemsize), for the reference's block model.
QUANT_WBYTES = {"none": None, "int8": 1.0, "int4": 0.5}

# the rungs that take a pre-encoded tiled weight
TILED_IMPLS = ("cuda", "xla", "xla_gather")

# The reference's static block model budget (its per-step VMEM model):
# kept so bn and KB, which the encodings bake in, match its plans exactly.
# The CUDA kernels choose their own CTA tiles (see csrc/balanced_spmm.cu).
_VMEM_BUDGET = 4 * 1024 * 1024


def bucket_m(m: int) -> int:
    """Next power of two at or above ``m`` (minimum 1)."""
    return 1 << max(int(m) - 1, 0).bit_length()


class InjectedKernelFault(RuntimeError):
    """Raised by an armed fault-injection site (`repro_torch.testing.faults`)."""


# Kernel-dispatch fault-injection sites: rung name (``cuda``, ``xla``,
# ``xla_gather``, and the decode branches ``cuda_decode``, ``xla_decode``)
# -> predicate(ctx) -> bool.  Armed only by
# `repro_torch.testing.faults.force_impl_failure`; empty (the default) it
# costs one falsy dict check per dispatch.
_FORCED_FAULTS: dict = {}


def _fault_trip(site: str, **ctx) -> None:
    if _FORCED_FAULTS:
        pred = _FORCED_FAULTS.get(site)
        if pred is not None and pred(ctx):
            raise InjectedKernelFault(
                f"injected kernel fault at impl {site!r} ({ctx})")


def _trip(impl: str, skinny: bool, **ctx) -> None:
    """The fault sites of one dispatch on rung ``impl`` (the reference's
    sites, checked ahead of the autograd Functions): the rung's own, then,
    at skinny M, its decode branch (``xla_gather`` has none)."""
    if _FORCED_FAULTS:
        _fault_trip(impl, **ctx)
        if skinny and impl != "xla_gather":
            _fault_trip(f"{impl}_decode", **ctx)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_block(dim: int, preferred: int) -> int:
    """Largest power-of-two block <= preferred that keeps padding sane."""
    b = preferred
    while b > 8 and dim < b // 2:
        b //= 2
    return b


@dataclasses.dataclass(frozen=True)
class BlockChoice:
    bm: int
    bo: int
    bn: int
    vmem_bytes: int     # the reference model's per-step footprint


def _tiled_footprint(bm: int, bo: int, bn: int, kb: int, itemsize: int,
                     w_bytes: float | None = None) -> int:
    """x tile + (vals, idx) block + decoded f32 tile + f32 accumulator;
    ``w_bytes`` (`QUANT_WBYTES`) narrows the stored value slot and adds the
    ``[bo, 1]`` f32 scales tile."""
    wb = itemsize if w_bytes is None else w_bytes
    scales = 0 if w_bytes is None else bo * 4
    return int(bm * bn * itemsize + bo * kb * (wb + 4) + scales
               + bo * bn * 4 + bm * bo * 4)


def _tiled_kb_est(n: int, k: int, bn: int) -> int:
    """Balanced-invariant KB estimate (K * bn / N with 50% slack)."""
    return max(8, min(k, bn, _round_up(int(k * bn / max(n, 1) * 1.5), 8)))


def _bitmap_footprint(bm: int, bo: int, bn: int, k: int, itemsize: int) -> int:
    """The reference model's per-step bytes of the bitmap kernel: x tile +
    int8 bitmap block + the row block's whole packed run ``[bo, K]`` +
    offsets column + decoded f32 tile + f32 accumulator."""
    return (bm * bn * itemsize + bo * bn + bo * k * itemsize + bo * 4
            + bo * bn * 4 + bm * bo * 4)


@functools.lru_cache(maxsize=512)
def choose_blocks(m: int, o: int, n: int, k: int, *, itemsize: int = 4,
                  vmem_budget: int = _VMEM_BUDGET, kind: str = "tiled",
                  bn: int | None = None,
                  w_bytes: float | None = None) -> BlockChoice:
    """Pick (bm, bo, bn) with the reference's static model: start from
    128s shrunk toward small dims, then halve the largest footprint share
    until the double-buffered footprint fits the budget.  ``kind``
    "tiled" estimates KB from the balanced invariant, "bitmap" takes ``k``
    as the packed width; ``bn`` given pins the column block (the bitmap
    offsets bake it in), so only bm and bo may shrink.  ``w_bytes`` narrows
    the modeled value slot of a quantized encoding."""
    bm = _pick_block(m, 128)
    bo = _pick_block(o, 128)
    bn_fixed = bn is not None
    if not bn_fixed:
        bn = _pick_block(n, 128)

    def footprint(bm_, bo_, bn_):
        if kind == "bitmap":
            return _bitmap_footprint(bm_, bo_, bn_, k, itemsize)
        return _tiled_footprint(bm_, bo_, bn_, _tiled_kb_est(n, k, bn_),
                                itemsize, w_bytes)

    wb = itemsize if w_bytes is None else w_bytes
    while 2 * footprint(bm, bo, bn) > vmem_budget:
        # shrink the largest contributor; keep everything >= 8
        if kind == "bitmap":
            shares = {
                "bm": bm * (bn * itemsize + bo * 4),
                "bo": bo * (bn + k * itemsize + 4 + bn * 4 + bm * 4),
            }
        else:
            shares = {
                "bm": bm * (bn * itemsize + bo * 4),
                "bo": bo * (_tiled_kb_est(n, k, bn) * (wb + 4) + bn * 4
                            + bm * 4),
                "bn": bn * (bm * itemsize + bo * 4),
            }
        if bn_fixed:
            shares.pop("bn", None)
        dims = {"bm": bm, "bo": bo, "bn": bn}
        for name in sorted(shares, key=shares.get, reverse=True):
            if dims[name] > 8:
                dims[name] //= 2
                break
        else:
            break   # everything at the floor; accept the overshoot
        bm, bo, bn = dims["bm"], dims["bo"], dims["bn"]
    return BlockChoice(bm=bm, bo=bo, bn=bn, vmem_bytes=footprint(bm, bo, bn))


def halve_blocks(c: BlockChoice, *, kb: int | None = None,
                 itemsize: int = 4) -> BlockChoice | None:
    """One retry step of the guard's degradation ladder: halve bm / bo
    toward the 8-floor; ``bn`` stays (the encoding bakes it in).  None at
    the floor.  ``kb`` refreshes the modeled footprint (bookkeeping: on the
    ``cuda`` rung bm and bo set only the wrappers' padding)."""
    if c.bm <= 8 and c.bo <= 8:
        return None
    bm = max(8, c.bm // 2)
    bo = max(8, c.bo // 2)
    vmem = _tiled_footprint(bm, bo, c.bn, kb, itemsize) if kb \
        else c.vmem_bytes
    return BlockChoice(bm=bm, bo=bo, bn=c.bn, vmem_bytes=vmem)


# ---------------------------------------------------------------------------
# balanced_spmm: y = x @ W.T, W = (values[O, K], indices[O, K]) over N inputs
# ---------------------------------------------------------------------------

def _densify_gather(values: Tensor, indices: Tensor, n_in: int) -> Tensor:
    """Gather-only densify of ascending-index balanced rows -> ``[O, N]``:
    per dense column, binary-search the row's indices, take the value at
    the hit slot, zero the misses."""
    o, k = values.shape
    idx = indices.long().contiguous()
    cols = torch.arange(n_in, device=values.device)
    slot = torch.searchsorted(idx, cols.expand(o, n_in).contiguous())
    slot = slot.clamp(0, k - 1)
    hit = idx.gather(1, slot) == cols[None, :]
    return torch.where(hit, values.gather(1, slot),
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device))


def _balanced_spmm_xla(x: Tensor, values: Tensor, indices: Tensor,
                       n_in: int) -> Tensor:
    if x.shape[0] <= SKINNY_M:
        return ref.balanced_spmm_gather(x, values, indices)
    w = _densify_gather(values, indices, n_in)
    return (x.float() @ w.float().T).to(x.dtype)


# ---------------------------------------------------------------------------
# Tile-format encoding cache of the flat ``cuda`` rung (keyed per weight)
# ---------------------------------------------------------------------------

# A key holds the source tensors' ids and version counters (an in-place
# update bumps the version, so it misses); the entry holds weak references
# to the sources, checked on every hit, whose finalizers evict the entry
# when a source dies, so a recycled id never hits a stale encoding and a
# training loop making fresh weights every step pins nothing.  A bounded
# FIFO caps it either way (the reference's `_ENC_CACHE` / `_KB_CACHE`).
_ENC_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_ENC_CACHE_MAX = 64
_KB_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()


def _weight_key(*tensors: Tensor) -> tuple:
    return tuple((id(t), t._version) for t in tensors)


def _cache_put(cache, key, entry, *sources: Tensor) -> None:
    def evict(_ref, cache=cache, key=key):
        cache.pop(key, None)
    cache[key] = (tuple(weakref.ref(t, evict) for t in sources), entry)
    while len(cache) > _ENC_CACHE_MAX:
        cache.popitem(last=False)


def _cache_get(cache, key, *sources: Tensor):
    hit = cache.get(key)
    if hit is None:
        return None
    refs, entry = hit
    if any(r() is not t for r, t in zip(refs, sources)):
        cache.pop(key, None)       # the id now names another tensor
        return None
    cache.move_to_end(key)
    return entry


def _encode_cached(values: Tensor, indices: Tensor, n_in: int, bn: int,
                   kb: int, dtype: torch.dtype) -> TiledBalanced:
    """`encode_tiled` of a flat weight (values cast to ``dtype``), cached
    per (values, indices) pair while both live unchanged."""
    key = _weight_key(values, indices) + (n_in, bn, kb, dtype)
    tb = _cache_get(_ENC_CACHE, key, values, indices)
    if tb is None:
        tb = encode_tiled(values.detach().to(dtype), indices, n_in, bn=bn,
                          kb=kb)
        _cache_put(_ENC_CACHE, key, tb, values, indices)
    return tb


def _static_kb(values: Tensor, indices: Tensor, n_in: int, bn: int,
               block_k: int | None) -> int:
    """Static per-block capacity: the caller's hint (rounded up to 8), else
    measured from the indices, cached per indices tensor so repeated calls
    on one weight do not read the indices back to the host again."""
    if block_k is not None:
        return max(8, _round_up(block_k, 8))
    key = _weight_key(indices) + (n_in, bn)
    kb = _cache_get(_KB_CACHE, key, indices)
    if kb is None:
        kb = max_block_count(indices, n_in, bn)
        _cache_put(_KB_CACHE, key, kb, indices)
    return kb


class _BalancedSpmmCuda(torch.autograd.Function):
    """The flat weight's ``cuda`` rung: cached tile encoding, then the
    wide or skinny kernel; backward as the reference's ``_balanced_bwd``
    (``dx = dy @ W`` on the gather-densified weight, ``dvalues[o, j] =
    sum_m dy[m, o] x[m, idx[o, j]]``)."""

    @staticmethod
    def forward(ctx, x, values, indices, n_in, bm, bo, bn, kb):
        ctx.save_for_backward(x, values, indices)
        ctx.n_in = n_in
        tb = _encode_cached(values, indices, n_in, bn, kb, x.dtype)
        return _pad_and_run_tiled(x, tb, bm, bo,
                                  skinny=x.shape[0] <= SKINNY_M)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices = ctx.saved_tensors
        w = _densify_gather(values, indices, ctx.n_in)
        dx = (dy.float() @ w.float()).to(x.dtype)
        xg = x[:, indices.long()].float()                     # [M, O, K]
        dvals = torch.einsum("mo,mok->ok", dy.float(), xg).to(values.dtype)
        return dx, dvals, None, None, None, None, None, None


def balanced_spmm(x: Tensor, values: Tensor, indices: Tensor, *, n_in: int,
                  impl: str = "xla", block_k: int | None = None) -> Tensor:
    """Balanced-sparse matmul on *flat-format* weights (``values[O, K]``,
    ascending ``indices[O, K]`` over ``n_in`` columns).  ``x``: ``[..., N]``
    -> ``[..., O]``; differentiable through autograd.

    ``cuda`` is the ad-hoc kernel entry: the weight is encoded to
    `TiledBalanced` at `choose_blocks`' bn (KB ``block_k``, else measured)
    behind the per-weight cache, then runs the wide or (M <= `SKINNY_M`)
    skinny kernel.  Plan-driven callers use the pre-encoded `tiled_spmm`.
    ``xla`` / ``xla_gather`` are the eager rungs."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    skinny = x2.shape[0] <= SKINNY_M
    if impl == "cuda":
        c = choose_blocks(x2.shape[0], values.shape[0], n_in,
                          values.shape[1], itemsize=x.element_size())
        _trip("cuda", skinny, bm=c.bm, bo=c.bo, bn=c.bn)
        kb = _static_kb(values, indices, n_in, c.bn, block_k)
        y = _BalancedSpmmCuda.apply(x2, values, indices, n_in, c.bm, c.bo,
                                    c.bn, kb)
    elif impl == "xla":
        _trip("xla", skinny)
        y = _balanced_spmm_xla(x2, values, indices, n_in)
    elif impl == "xla_gather":
        _trip("xla_gather", skinny)
        y = ref.balanced_spmm_gather(x2, values, indices)
    else:
        raise ValueError(f"balanced_spmm runs impl 'cuda', 'xla' or "
                         f"'xla_gather', got {impl!r}")
    return y.reshape(*lead, values.shape[0])


# ---------------------------------------------------------------------------
# tiled_spmm: the pre-encoded (plan-driven) entry point
# ---------------------------------------------------------------------------

def _pad_o(tb: TiledBalanced, rows: int) -> TiledBalanced:
    """``tb`` with ``rows`` all-zero output rows appended: they decode to
    all-zero tiles (a zero scale over zero q slots is the valid empty
    block of a quantized encoding)."""
    pad3, pad2 = (0, 0, 0, 0, 0, rows), (0, 0, 0, rows)
    return TiledBalanced(F.pad(tb.values, pad3), F.pad(tb.indices, pad3),
                         F.pad(tb.counts, pad2), n_in=tb.n_in, bn=tb.bn,
                         scales=None if tb.scales is None
                         else F.pad(tb.scales, pad2), quant=tb.quant)


def _pad_and_run_tiled(x: Tensor, tb: TiledBalanced, bm: int, bo: int,
                       skinny: bool = False) -> Tensor:
    """Pad (M, O, N) to tile multiples, run the kernel, slice back and cast
    to x's dtype.  ``skinny`` selects the decode kernel, which pads M to
    its 8-row tile itself (rows past M read as zero), so M is not padded
    here; no copy is made where nothing needs padding."""
    m = x.shape[0]
    o = tb.n_out
    mp = m if skinny else _round_up(m, bm)
    op_ = _round_up(o, bo)
    pad_n = tb.nb * tb.bn - x.shape[1]
    xp = F.pad(x, (0, pad_n, 0, mp - m)) if pad_n or mp != m else x
    if op_ != o:
        tb = _pad_o(tb, op_ - o)
    if skinny:
        y = tiled_balanced_spmm_skinny(xp, tb, bo=bo)
    else:
        y = tiled_balanced_spmm(xp, tb, bm=bm, bo=bo)
    return y[:m, :o].to(x.dtype)


def _require_tiled_rung(name: str, impl: str) -> None:
    if impl not in TILED_IMPLS:
        raise ValueError(f"{name} runs impl {' / '.join(TILED_IMPLS)}, got "
                         f"{impl!r}")


class _TiledSpmm(torch.autograd.Function):
    """Kernel forward; backward as the reference's ``_tiled_bwd``:
    ``dx = dy @ W`` on the densified weight, ``dvalues`` gathered from
    ``dy^T @ x`` at each slot's column with pad slots (slot >= count)
    forced to exactly 0."""

    @staticmethod
    def forward(ctx, x, values, indices, counts, n_in, bn, bm, bo, skinny):
        ctx.save_for_backward(x, values, indices, counts)
        ctx.n_in, ctx.bn = n_in, bn
        tb = TiledBalanced(values, indices, counts, n_in=n_in, bn=bn)
        return _pad_and_run_tiled(x, tb, bm, bo, skinny=skinny)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices, counts = ctx.saved_tensors
        n_in, bn = ctx.n_in, ctx.bn
        o, nb, kb = values.shape
        w = tiled_to_dense(TiledBalanced(values, indices, counts,
                                         n_in=n_in, bn=bn))      # [O, N]
        dx = (dy.float() @ w.float()).to(x.dtype)
        dw = F.pad(dy.float().T @ x.float(), (0, nb * bn - n_in))
        cols = (torch.arange(nb, device=x.device)[None, :, None] * bn
                + indices.long()).reshape(o, nb * kb)
        gathered = dw.gather(1, cols).reshape(o, nb, kb)
        valid = torch.arange(kb, device=x.device) < counts[..., None]
        dvals = torch.where(valid, gathered, 0.0).to(values.dtype)
        return dx, dvals, None, None, None, None, None, None, None


def _densify_gather_tiled(values: Tensor, indices: Tensor, counts: Tensor,
                          scales: Tensor | None, bn: int,
                          quant: str) -> Tensor:
    """Gather-only densify of a (perm-free or packed-space) tiled encoding
    -> ``[O, NB*bn]``, dequantized (f32; the values' dtype unquantized):
    per block, binary-search the block-local indices, which ascend over the
    live slots, with pad slots re-pointed at the sentinel ``bn`` so every
    searched row is sorted (the reference's ``_densify_gather_tiled``)."""
    o, nb, kb = indices.shape
    vals = dequantize_values(values, scales, quant, kb).reshape(o * nb, kb)
    valid = torch.arange(kb, device=indices.device) < counts[..., None]
    idx = torch.where(valid, indices, bn).reshape(o * nb, kb).contiguous()
    cols = torch.arange(bn, dtype=idx.dtype, device=idx.device)
    slot = torch.searchsorted(idx, cols.expand(o * nb, bn).contiguous())
    slot = slot.clamp(0, kb - 1)
    hit = idx.gather(1, slot) == cols
    out = torch.where(hit, vals.gather(1, slot), vals.new_zeros(()))
    return out.reshape(o, nb * bn)


def _tiled_gather_spmm(x: Tensor, values: Tensor, indices: Tensor,
                       scales: Tensor | None, bn: int, quant: str) -> Tensor:
    """Gather + reduction on the tiled encoding, no densify: an
    ``[M, O, NB*KB]`` buffer of x at every slot's column (pad slots carry
    value 0).  A quantized encoding sums ``x * q`` per block and multiplies
    by the block's scale after (``sum_s x*q*scale == scale * sum_s x*q``,
    the reference's factoring).  Returns f32 ``[M, O]``."""
    o, nb, kb = indices.shape
    cols = (torch.arange(nb, device=x.device)[None, :, None] * bn
            + indices.long()).reshape(o, nb * kb)
    xg = F.pad(x, (0, nb * bn - x.shape[1]))[:, cols].float()  # [M, O, S]
    if quant == "none":
        return torch.einsum("mos,os->mo", xg,
                            values.reshape(o, nb * kb).float())
    q = unpack_int4(values, kb) if quant == "int4" else values
    partial = torch.einsum("mons,ons->mon", xg.reshape(-1, o, nb, kb),
                           q.float())
    return torch.einsum("mon,on->mo", partial, scales)


def _tiled_eager(x: Tensor, values: Tensor, indices: Tensor, counts: Tensor,
                 scales: Tensor | None, bn: int, quant: str,
                 impl: str) -> Tensor:
    """The eager rungs on one (expert's) tiled encoding, f32 ``[M, O]``:
    the gather (up to `GATHER_M` rows, always for ``xla_gather``), else
    the dequantizing densify + f32 matmul."""
    if impl == "xla_gather" or x.shape[0] <= GATHER_M:
        return _tiled_gather_spmm(x, values, indices, scales, bn, quant)
    w = _densify_gather_tiled(values, indices, counts, scales, bn, quant)
    return x.float() @ w[:, :x.shape[1]].float().T


def _tiled_dx(dy: Tensor, x: Tensor, values: Tensor, indices: Tensor,
              counts: Tensor, scales: Tensor | None, bn: int,
              quant: str) -> Tensor:
    """Straight-through ``dx = dy @ W`` (f32) on the dequantized weight."""
    w = _densify_gather_tiled(values, indices, counts, scales, bn, quant)
    return dy.float() @ w[:, :x.shape[1]].float()


def _straight_through_values(values: Tensor) -> Tensor | None:
    """The quant Functions' cotangent for ``values``: none for integer
    words, zeros for float ones (the reference's straight-through rule)."""
    return torch.zeros_like(values) if values.is_floating_point() else None


class _TiledSpmmQ(torch.autograd.Function):
    """The tiled matmul with rung routing (the reference's
    ``_tiled_spmm_q``): ``cuda`` runs the kernels (the quant ones for a
    quantized encoding), ``xla`` / ``xla_gather`` `_tiled_eager`.  Backward
    is straight-through: ``dx = dy @ W`` on the dequantized weight; integer
    values and the scales get no gradient, float values zeros."""

    @staticmethod
    def forward(ctx, x, values, indices, counts, scales, n_in, bn, bm, bo,
                skinny, quant, impl):
        ctx.save_for_backward(x, values, indices, counts, scales)
        ctx.bn, ctx.quant = bn, quant
        if impl == "cuda":
            tb = TiledBalanced(values, indices, counts, n_in=n_in, bn=bn,
                               scales=scales, quant=quant)
            return _pad_and_run_tiled(x, tb, bm, bo, skinny=skinny)
        return _tiled_eager(x, values, indices, counts, scales, bn, quant,
                            impl).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices, counts, scales = ctx.saved_tensors
        dx = _tiled_dx(dy, x, values, indices, counts, scales, ctx.bn,
                       ctx.quant).to(x.dtype)
        return (dx, _straight_through_values(values)) + (None,) * 10


def tiled_spmm(x: Tensor, tb: TiledBalanced, *, block_m: int | None = None,
               block_o: int | None = None, impl: str = "cuda") -> Tensor:
    """Differentiable balanced-sparse matmul on a *pre-encoded*
    `TiledBalanced` weight (the plan-driven entry).  ``x``: ``[..., N]`` ->
    ``[..., O]``.  Skinny M (<= `SKINNY_M`) runs the decode kernel with M
    padded to 8; wider M the prefill kernel at ``block_m``/``block_o``.
    Packed encodings permute ``x`` into packed column space here, outside
    the autograd Function, so autograd carries the gradient back through
    the permutation.  An unquantized encoding on ``cuda`` takes
    `_TiledSpmm`; a quantized one, or any encoding on ``xla`` /
    ``xla_gather``, the routing of `_TiledSpmmQ` (the reference's
    routing)."""
    _require_tiled_rung("tiled_spmm", impl)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    n_eff = tb.n_in
    if tb.perm is not None:
        npack = tb.nb * tb.bn
        x2 = F.pad(x2, (0, npack - x2.shape[1])).index_select(
            1, leaf_perm(tb.perm).long())
        n_eff = npack
    m = x2.shape[0]
    skinny = m <= SKINNY_M
    bm = _round_up(m, 8) if skinny else _pick_block(m, block_m or 128)
    bo = _pick_block(tb.n_out, block_o or 128)
    _trip(impl, skinny, **({"bm": bm, "bo": bo, "bn": tb.bn}
                           if impl == "cuda" else {}))
    if tb.quant == "none" and impl == "cuda":
        y = _TiledSpmm.apply(x2, tb.values, tb.indices, tb.counts, n_eff,
                             tb.bn, bm, bo, skinny)
    else:
        y = _TiledSpmmQ.apply(x2, tb.values, tb.indices, tb.counts,
                              tb.scales, n_eff, tb.bn, bm, bo, skinny,
                              tb.quant, impl)
    return y.reshape(*lead, tb.n_out)


# ---------------------------------------------------------------------------
# tiled_spmm_batched: the MoE experts, [E, M, N] x W[E, O, NB, KB]
# ---------------------------------------------------------------------------

def _pad_and_run_batched(x: Tensor, tb: TiledBalanced, bm: int,
                         bo: int) -> Tensor:
    """Pad every expert's (M, O, N) to tile multiples, run the batched
    kernel, slice back and cast to x's dtype (the reference's
    ``_tiled_spmm_batched``).  O is padded with all-zero rows only when it
    is ragged (the plan's shapes are not)."""
    _, m, n = x.shape
    o = tb.indices.shape[1]
    mp, op_ = _round_up(m, bm), _round_up(o, bo)
    pad_n = tb.nb * tb.bn - n
    xp = F.pad(x, (0, pad_n, 0, mp - m)) if pad_n or mp != m else x
    if op_ != o:
        tb = _pad_o(tb, op_ - o)
    y = tiled_balanced_spmm_batched(xp, tb, bm=bm, bo=bo)
    return y[:, :m, :o].to(x.dtype)


class _TiledSpmmBatched(torch.autograd.Function):
    """Batched kernel forward; backward as the reference's
    ``_tiled_batched_bwd``: per expert ``dx = dy @ W`` on the densified
    weight and ``dvalues`` gathered from ``dy^T @ x`` at each slot's column,
    pad slots (slot >= count) exactly 0."""

    @staticmethod
    def forward(ctx, x, values, indices, counts, n_in, bn, bm, bo):
        ctx.save_for_backward(x, values, indices, counts)
        ctx.n_in, ctx.bn = n_in, bn
        tb = TiledBalanced(values, indices, counts, n_in=n_in, bn=bn)
        return _pad_and_run_batched(x, tb, bm, bo)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices, counts = ctx.saved_tensors
        n_in, bn = ctx.n_in, ctx.bn
        e, o, nb, kb = values.shape
        w = tiled_to_dense(TiledBalanced(values, indices, counts,
                                         n_in=n_in, bn=bn))   # [E, O, N]
        dx = torch.bmm(dy.float(), w.float()).to(x.dtype)
        dw = F.pad(torch.bmm(dy.float().transpose(1, 2), x.float()),
                   (0, nb * bn - n_in))                          # [E, O, NBbn]
        cols = (torch.arange(nb, device=x.device)[:, None] * bn
                + indices.long()).reshape(e, o, nb * kb)
        gathered = dw.gather(2, cols).reshape(e, o, nb, kb)
        valid = torch.arange(kb, device=x.device) < counts[..., None]
        dvals = torch.where(valid, gathered, 0.0).to(values.dtype)
        return dx, dvals, None, None, None, None, None, None


def _expert(t: Tensor | None, g: int) -> Tensor | None:
    return None if t is None else t[g]


class _TiledSpmmBatchedQ(torch.autograd.Function):
    """The experts' tiled matmul with rung routing (the reference's
    ``_tiled_spmm_batched_q``): ``cuda`` one batched kernel launch (the
    quant one for a quantized encoding), the eager rungs expert by expert
    as `_TiledSpmmQ` does; straight-through backward as there."""

    @staticmethod
    def forward(ctx, x, values, indices, counts, scales, n_in, bn, bm, bo,
                quant, impl):
        ctx.save_for_backward(x, values, indices, counts, scales)
        ctx.bn, ctx.quant = bn, quant
        if impl == "cuda":
            tb = TiledBalanced(values, indices, counts, n_in=n_in, bn=bn,
                               scales=scales, quant=quant)
            return _pad_and_run_batched(x, tb, bm, bo)
        return torch.stack([
            _tiled_eager(x[g], values[g], indices[g], counts[g],
                         _expert(scales, g), bn, quant, impl)
            for g in range(x.shape[0])]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, values, indices, counts, scales = ctx.saved_tensors
        dx = torch.stack([
            _tiled_dx(dy[g], x[g], values[g], indices[g], counts[g],
                      _expert(scales, g), ctx.bn, ctx.quant)
            for g in range(x.shape[0])]).to(x.dtype)
        return (dx, _straight_through_values(values)) + (None,) * 9


def tiled_spmm_batched(x: Tensor, tb: TiledBalanced, *,
                       block_m: int | None = None,
                       block_o: int | None = None,
                       impl: str = "cuda") -> Tensor:
    """Every expert's balanced-sparse matmul in ONE kernel launch (the
    plan-driven MoE entry).  ``x``: ``[E, ..., N]``; ``tb`` leaves carry the
    matching expert axis (values ``[E, O, NB, KB]``, one shared
    BlockChoice / KB).  Skinny per-expert M (the capacity, <= `SKINNY_M`)
    pins bm to M padded to 8; the kernel then takes its 8-row tile.  A
    packed encoding permutes x into packed column space here, outside the
    autograd Function: a lead-broadcast perm ``[E, NB*bn]`` row by row,
    a single ``[NB*bn]`` perm for all experts.  Routed as `tiled_spmm`
    (quantized or eager-rung encodings through `_TiledSpmmBatchedQ`).
    Differentiable."""
    _require_tiled_rung("tiled_spmm_batched", impl)
    e = x.shape[0]
    lead = x.shape[1:-1]
    o = tb.indices.shape[1]
    x3 = x.reshape(e, -1, x.shape[-1])
    n_eff = tb.n_in
    if tb.perm is not None:
        npack = tb.nb * tb.bn
        x3 = F.pad(x3, (0, npack - x3.shape[2]))
        if tb.perm.ndim > 1:
            perm = tb.perm.reshape(-1, tb.perm.shape[-1])[:e].long()
            x3 = x3.gather(2, perm[:, None, :].expand(e, x3.shape[1], npack))
        else:
            x3 = x3.index_select(2, tb.perm.long())
        n_eff = npack
    m = x3.shape[1]
    bm = _round_up(m, 8) if m <= SKINNY_M else _pick_block(m, block_m or 128)
    bo = _pick_block(o, block_o or 128)
    if impl == "cuda":                  # the batched kernel: no decode site
        _trip("cuda", False, bm=bm, bo=bo, bn=tb.bn, batched=True)
    else:
        _trip(impl, m <= SKINNY_M, batched=True)
    if tb.quant == "none" and impl == "cuda":
        y = _TiledSpmmBatched.apply(x3, tb.values, tb.indices, tb.counts,
                                    n_eff, tb.bn, bm, bo)
    else:
        y = _TiledSpmmBatchedQ.apply(x3, tb.values, tb.indices, tb.counts,
                                     tb.scales, n_eff, tb.bn, bm, bo,
                                     tb.quant, impl)
    return y.reshape(e, *lead, o)


# ---------------------------------------------------------------------------
# balanced_spmm_batched: the experts' flat-format eager rungs
# ---------------------------------------------------------------------------

def _batched_gather_spmm(x: Tensor, values: Tensor, indices: Tensor) -> Tensor:
    """Per-expert gather + reduction: ``[E, C, N] x [E, O, K] -> [E, C, O]``
    (an ``[E, C, O, K]`` buffer)."""
    e = x.shape[0]
    xg = x[torch.arange(e, device=x.device)[:, None, None, None],
           torch.arange(x.shape[1], device=x.device)[None, :, None, None],
           indices.long()[:, None]]                          # [E, C, O, K]
    return torch.einsum("ecok,eok->eco", xg.float(),
                        values.float()).to(x.dtype)


def balanced_spmm_batched(x: Tensor, values: Tensor, indices: Tensor, *,
                          n_in: int, impl: str = "xla") -> Tensor:
    """Every expert's flat-format balanced matmul, ``[E, ..., N] x
    values/indices [E, O, K] -> [E, ..., O]``: the MoE fallback rungs.
    ``xla_gather`` gathers; ``xla`` gathers at skinny capacity (<=
    `SKINNY_M`) and otherwise densifies each expert right before its f32
    matmul.  Differentiable through autograd."""
    e = x.shape[0]
    lead = x.shape[1:-1]
    x3 = x.reshape(e, -1, x.shape[-1])
    if impl in ("xla", "xla_gather"):
        _trip(impl, x3.shape[1] <= SKINNY_M, batched=True)
    if impl == "xla_gather" or (impl == "xla" and x3.shape[1] <= SKINNY_M):
        y = _batched_gather_spmm(x3, values, indices)
    elif impl == "xla":
        y = torch.stack([
            x3[i].float() @ _densify_gather(values[i], indices[i],
                                            n_in).float().T
            for i in range(e)]).to(x.dtype)
    else:
        raise ValueError(f"balanced_spmm_batched runs impl 'xla' or "
                         f"'xla_gather' (the 'cuda' rung takes a "
                         f"TiledBalanced via tiled_spmm_batched), got "
                         f"{impl!r}")
    return y.reshape(e, *lead, values.shape[-2])


# ---------------------------------------------------------------------------
# bitmap_spmm: y = x @ W.T, W bitmap-compressed
# ---------------------------------------------------------------------------

def bitmap_spmm(x: Tensor, bitmap: Tensor, packed: Tensor, offsets: Tensor,
                *, bn: int = 128, impl: str = "cuda") -> Tensor:
    """Bitmap-compressed matmul (an inference format; not differentiable).
    ``x``: ``[..., N]`` -> ``[..., O]`` in x's dtype.  ``cuda`` pads M and
    O to the reference's block choice and runs the kernel (its plain
    version on a CPU tensor); ``xla`` runs `ref.bitmap_spmm_ref`."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m, n = x2.shape
    o = bitmap.shape[0]
    if impl == "xla":
        return ref.bitmap_spmm_ref(x2, bitmap, packed).reshape(*lead, o)
    if impl != "cuda":
        raise ValueError(f"bitmap_spmm runs impl 'cuda' or 'xla', got "
                         f"{impl!r}")
    if n % bn:
        raise ValueError(f"N = {n} must be a multiple of bn = {bn} (pad N "
                         "before encoding)")
    c = choose_blocks(m, o, n, packed.shape[1], itemsize=x.element_size(),
                      kind="bitmap", bn=bn)
    mp, op_ = _round_up(m, c.bm), _round_up(o, c.bo)
    if mp != m:
        x2 = F.pad(x2, (0, 0, 0, mp - m))
    if op_ != o:
        bitmap, packed, offsets = (F.pad(t, (0, 0, 0, op_ - o))
                                   for t in (bitmap, packed, offsets))
    y = bitmap_spmm_kernel(x2, bitmap, packed, offsets, bn=bn)
    return y[:m, :o].to(x.dtype).reshape(*lead, o)


def encode_bitmap(w: Tensor, *, bn: int = 128, k: int | None = None):
    """Dense ``[O, N]`` -> ``(bitmap, packed, offsets)``; N must be a
    multiple of ``bn``."""
    return bitmap_encode(w, bn, k=k)


__all__ = ["balanced_spmm", "balanced_spmm_batched", "tiled_spmm",
           "tiled_spmm_batched", "bitmap_spmm", "encode_bitmap",
           "choose_blocks", "BlockChoice", "SKINNY_M",
           "GATHER_M", "QUANT_WBYTES", "TILED_IMPLS", "bucket_m",
           "halve_blocks", "InjectedKernelFault"]
