"""Balanced-sparse x dense matmul on the tile-local format: the CUDA kernels'
wrappers, their plain PyTorch version and their launch counters.

Counterpart of `repro.kernels.balanced_spmm` (Pallas TPU kernels):

* `tiled_balanced_spmm`        <- ``tiled_balanced_spmm_pallas`` (prefill,
  wide M), kernel ``tiled_spmm_wide`` in ``csrc/balanced_spmm.cu``;
* `tiled_balanced_spmm_skinny` <- ``tiled_balanced_spmm_skinny_pallas``
  (decode, M <= 8), kernel ``tiled_spmm_skinny`` (bf16: the weight
  streamer of ``csrc/skinny_spmm.cuh``, `stream_route`);
* `tiled_balanced_spmm_batched` <- ``tiled_balanced_spmm_batched_pallas``
  (the MoE experts, one launch over the expert grid), kernel
  ``tiled_spmm_batched``.

A block-quantized encoding (``tb.quant`` int8 or int4) launches the
quantized twin of each, ``tiled_spmm_wide_q`` / ``_skinny_q`` /
``_batched_q`` in ``csrc/balanced_spmm_q.cu`` (the reference's
``_kernel_q``, ``_kernel_skinny_q``, ``_kernel_batched_q``), counted apart
under the ``_q`` names of `LAUNCHES`; it dequantizes each slot on chip
right before the decode.

They compute ``y[M, O] = x[M, NB*bn] @ decode(W)^T`` (per expert for the
batched one) in f32 and return the f32 accumulator (the caller casts).  A
bf16 wide call (and a batched one past `SKINNY_MAX_M`) runs the
tensor-core kernel (``csrc/tc_spmm.cuh``): `wide_splits` picks how many
parts its column blocks split into, and the wrapper allocates the
partials' workspace (`split_workspace`); float32 keeps the FMA kernels
(`tensor_core_route`).  A bf16 skinny call (and a batched one up to
`SKINNY_MAX_M`) streams each block's live prefix (its counts, passed to the
kernel) past an x held in shared memory (`stream_route`,
`stream_x_ranges`).  On
a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs `tiled_balanced_spmm_plain` / `tiled_balanced_spmm_batched_plain`.
There is no fallback from the kernel to the plain version.  W is an
encoding as `tile_format.encode_tiled` (and `quantize_tiled`) makes it:
the nonzero slots of one row and block hold distinct columns (the kernels
store them, see the source note).

The source notes in ``csrc/balanced_spmm.cu`` and ``csrc/balanced_spmm_q.cu``
give each kernel's bound on an H100 and what its design does about it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .tile_format import TiledBalanced, dequantize_values

Tensor = torch.Tensor

# launches per kernel; counted where the kernel is launched and nowhere else
LAUNCHES = {"tiled_balanced_spmm": 0, "tiled_balanced_spmm_skinny": 0,
            "tiled_balanced_spmm_batched": 0, "tiled_balanced_spmm_q": 0,
            "tiled_balanced_spmm_skinny_q": 0,
            "tiled_balanced_spmm_batched_q": 0}

# kernel name -> (csrc source stem, C entry point)
_C_FN = {"tiled_balanced_spmm": ("balanced_spmm", "tiled_spmm_wide"),
         "tiled_balanced_spmm_skinny": ("balanced_spmm", "tiled_spmm_skinny"),
         "tiled_balanced_spmm_batched": ("balanced_spmm",
                                         "tiled_spmm_batched"),
         "tiled_balanced_spmm_q": ("balanced_spmm_q", "tiled_spmm_wide_q"),
         "tiled_balanced_spmm_skinny_q": ("balanced_spmm_q",
                                          "tiled_spmm_skinny_q"),
         "tiled_balanced_spmm_batched_q": ("balanced_spmm_q",
                                           "tiled_spmm_batched_q")}
_ERROR_FN = {"balanced_spmm": "spmm_error_string",
             "balanced_spmm_q": "spmm_q_error_string"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the stored value dtype and the kernels' weight-format code per quant mode
_QUANT_VALUES = {"int8": (torch.int8, 1), "int4": (torch.uint8, 2)}
SKINNY_MAX_M = 8
MAX_BN = 128      # widest column block (and block capacity) the kernels take
# the tensor-core wide kernel (bf16 x): 64 output rows (O) per CTA, a token
# tile of 32, 64 or 128 rows of x (`token_tile`), at most 64 splits of NB
TC_BO = 64
TC_MAX_SPLITS = 64
H100_SMS = 132
# the skinny weight streamer (bf16, M <= 8; csrc/skinny_spmm.cuh): 8 warps
# a CTA, each with a ring of 3 stages, a 16-byte header per staged block,
# at most 227 KB of shared memory a CTA
STREAM_WARPS, STREAM_STAGES, STREAM_HEADER = 8, 3, 16
STREAM_SMEM = 232448


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tensor_core_route(dtype: torch.dtype, m: int) -> bool:
    """Whether a wide call at M = ``m`` runs the tensor-core kernel and may
    split: bf16 above `SKINNY_MAX_M` (the batched and bitmap entries take
    their skinny kernel below it; the 2-D wide entry runs the tensor cores
    at any bf16 M, with one split below it).  float32 keeps the FMA
    kernels, whose sums hold the 1e-4 f32 bar (TF32 products would not)."""
    return dtype == torch.bfloat16 and m > SKINNY_MAX_M


def token_tile(m: int) -> int:
    """The tensor-core kernel's token tile for ``m`` rows of x (the C
    entry picks the same)."""
    return 32 if m <= 32 else 64 if m <= 64 else 128


def stream_route(dtype: torch.dtype, m: int) -> bool:
    """Whether a skinny call (the 2-D skinny entry, the batched one at
    ``m <= SKINNY_MAX_M``; the bitmap one likewise) runs the weight
    streamer of ``csrc/skinny_spmm.cuh``: bf16 only.  float32 keeps the FMA
    skinny templates (the f32 parity gates' route: its x at 4 bytes a value
    would not stay resident at N = 8192)."""
    return dtype == torch.bfloat16 and m <= SKINNY_MAX_M


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def stream_block_bytes(kb: int, quant: str = "none") -> int:
    """The shared-memory bytes of one staged column block in the
    streamer's ring (the tiled decoder): KB index words and the bytes of KB
    values, each padded to 16 bytes."""
    vbytes = {"none": 2 * kb, "int8": kb, "int4": (kb + 1) // 2}[quant]
    return _round16(4 * kb) + _round16(vbytes)


def stream_x_ranges(n: int, bn: int, block_bytes: int) -> int:
    """How many column ranges the streamer takes x in (its C launch picks
    the same): one while x, at 8 bf16 rows, fits beside the rings of
    one-block stages (`STREAM_WARPS` x `STREAM_STAGES` stages of
    ``STREAM_HEADER + block_bytes``) in a CTA's `STREAM_SMEM` bytes, else
    ranges of a multiple of 32 blocks.  It depends on the encoding alone,
    so a row's summation order is the same at every M."""
    cap = STREAM_SMEM - STREAM_WARPS * STREAM_STAGES * (STREAM_HEADER
                                                        + block_bytes)
    nb = n // bn
    if nb * bn * 16 <= cap:
        return 1
    rb = cap // (bn * 16) // 32 * 32
    if rb < 32:
        raise ValueError(f"the skinny streamer cannot hold 32 blocks of "
                         f"bn={bn} beside its rings")
    return -(-nb // rb)


def wide_splits(m: int, o: int, nb: int, *, experts: int = 1,
                sms: int = H100_SMS) -> int:
    """How many parts the tensor-core kernel splits the NB column blocks
    into: the largest divisor ``s`` of NB (at most `TC_MAX_SPLITS`) whose
    ``experts x O-tiles x M-tiles x s`` CTAs still run in one wave on
    ``sms`` SMs, one CTA each (a CTA holds up to 200 KB of shared memory,
    so an SM runs one), and 1 when the tiles alone fill the card.  A
    second wave would pay every CTA's prologue and epilogue again.  Each
    part writes a partial sum that a second pass adds in part order, so
    the result does not depend on the split's timing."""
    tiles = experts * -(-o // TC_BO) * -(-m // token_tile(m))
    best = 1
    for s in range(1, min(nb, TC_MAX_SPLITS) + 1):
        if nb % s == 0 and tiles * s <= sms:
            best = s
    return best


def workspace_numel(m: int, o: int, splits: int, experts: int = 1) -> int:
    """Floats of the split partials' workspace (none for one split)."""
    return 0 if splits == 1 else splits * experts * m * o


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_workspace(x: Tensor, m: int, o: int, nb: int,
                    experts: int = 1) -> tuple[int, Tensor | None]:
    """``(splits, workspace)`` of a wide-kernel call on ``x``'s device: one
    split and no workspace off the tensor-core route."""
    if not tensor_core_route(x.dtype, m):
        return 1, None
    splits = wide_splits(m, o, nb, experts=experts,
                         sms=_sms(x.device.index or 0))
    n = workspace_numel(m, o, splits, experts)
    return splits, (torch.empty(n, dtype=torch.float32, device=x.device)
                    if n else None)


def _slot_values(tb: TiledBalanced) -> Tensor:
    """Every slot's f32 value, ``[..., O, NB, KB]``: quantized encodings
    dequantized (``float(q) * scale``, as the quant kernels decode)."""
    return dequantize_values(tb.values, tb.scales, tb.quant, tb.kb).float()


def tiled_balanced_spmm_plain(x: Tensor, tb: TiledBalanced) -> Tensor:
    """The plain version of the wide and skinny kernels (and their quant
    twins): scatter-add every block's (dequantized) slots into a dense f32
    ``[O, NB*bn]`` weight (pad slots add 0), then one f32 matmul.  Returns
    f32 ``[M, O]``."""
    o, nb, kb = tb.indices.shape
    cols = (torch.arange(nb, device=x.device)[:, None] * tb.bn
            + tb.indices.long()).reshape(o, nb * kb)
    w = torch.zeros((o, nb * tb.bn), dtype=torch.float32, device=x.device)
    w.scatter_add_(1, cols, _slot_values(tb).reshape(o, nb * kb))
    return x.float() @ w.T


def tiled_balanced_spmm_batched_plain(x: Tensor, tb: TiledBalanced) -> Tensor:
    """The plain version of the batched kernel (and its quant twin): every
    expert's (dequantized) slots scatter-added into a dense f32
    ``[E, O, NB*bn]`` weight, then one f32 batched matmul.  ``x``:
    ``[E, M, NB*bn]``; returns f32 ``[E, M, O]``."""
    e, o, nb, kb = tb.indices.shape
    cols = (torch.arange(nb, device=x.device)[:, None] * tb.bn
            + tb.indices.long()).reshape(e, o, nb * kb)
    w = torch.zeros((e, o, nb * tb.bn), dtype=torch.float32, device=x.device)
    w.scatter_add_(2, cols, _slot_values(tb).reshape(e, o, nb * kb))
    return torch.bmm(x.float(), w.transpose(1, 2))


def _takes_counts(name: str) -> bool:
    """Whether C entry ``name`` takes the per-block live counts: the skinny
    and batched ones, whose bf16 route streams each block's live prefix."""
    return "skinny" in name or "batched" in name


def _lib(stem: str) -> ctypes.CDLL:
    lib = _build.load(stem)
    if not getattr(lib, "_typed", False):
        for name, (src, fn) in _C_FN.items():
            if src != stem:
                continue
            quant = name.endswith("_q")
            # x, values, indices, [counts: skinny and batched,] [scales,]
            # y; [E,] M, O, NB, KB, bn, dtype, [wfmt]; [ws, splits: not
            # skinny]; stream
            n_ptr = 4 + quant + _takes_counts(name)
            n_int = 6 + ("batched" in name) + quant
            split = [] if "skinny" in name else [ctypes.c_void_p,
                                                 ctypes.c_int]
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
                + split + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        err = getattr(lib, _ERROR_FN[stem])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(name: str, x: Tensor, tb: TiledBalanced) -> Tensor:
    """Launch kernel ``name``, or its quant twin (``name + "_q"``) for a
    quantized encoding; raise on anything the kernel does not take."""
    quant = tb.quant != "none"
    if quant:
        name += "_q"
        if tb.quant not in _QUANT_VALUES:
            raise ValueError(f"{name}: unknown quant {tb.quant!r}")
        vdtype, wfmt = _QUANT_VALUES[tb.quant]
        if tb.values.dtype != vdtype or tb.scales is None \
                or tb.scales.dtype != torch.float32:
            raise TypeError(f"{name}: {tb.quant} takes {vdtype} values and "
                            f"float32 scales, got {tb.values.dtype} / "
                            f"{None if tb.scales is None else tb.scales.dtype}")
        if tuple(tb.scales.shape) != tuple(tb.counts.shape):
            raise ValueError(f"{name}: scales {tuple(tb.scales.shape)} must "
                             f"match counts {tuple(tb.counts.shape)}")
    if x.dtype not in _DTYPES or (not quant and tb.values.dtype != x.dtype):
        raise TypeError(f"{name}: x must be float32 or bfloat16 (and share "
                        f"it with unquantized values), got {x.dtype} / "
                        f"{tb.values.dtype}")
    if tb.indices.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got "
                        f"{tb.indices.dtype}")
    counts = _takes_counts(name)
    if counts and (tb.counts.dtype != torch.int32 or tuple(tb.counts.shape)
                   != tuple(tb.indices.shape[:-1])):
        raise ValueError(f"{name}: counts must be int32 "
                         f"{tuple(tb.indices.shape[:-1])}, got "
                         f"{tb.counts.dtype} {tuple(tb.counts.shape)}")
    tensors = (x, tb.values, tb.indices) + ((tb.counts,) if counts else ()) \
        + ((tb.scales,) if quant else ())
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: x, values, indices (counts, scales) "
                         "must share one CUDA device")
    batched = name.startswith("tiled_balanced_spmm_batched")
    m = x.shape[-2]
    o, nb, kb = tb.indices.shape[-3:]
    kbv = -(-kb // 2) if tb.quant == "int4" else kb
    if tuple(tb.values.shape) != (*tb.indices.shape[:-1], kbv):
        raise ValueError(f"{name}: values {tuple(tb.values.shape)} do not "
                         f"hold KB={kb} {tb.quant} slots per block")
    if not (4 <= tb.bn <= MAX_BN and tb.bn % 4 == 0 and kb <= MAX_BN):
        raise ValueError(f"{name}: the kernel takes bn a multiple of 4 in "
                         f"[4, {MAX_BN}] and KB <= {MAX_BN}, got bn={tb.bn} "
                         f"KB={kb}")
    x = x.contiguous()
    ptrs = [t.contiguous() for t in tensors[1:]]
    y = torch.empty((*x.shape[:-2], m, o), dtype=torch.float32,
                    device=x.device)
    stem, fn = _C_FN[name]
    lib = _lib(stem)
    experts = (x.shape[0],) if batched else ()
    split = ()
    if "skinny" not in name:
        splits, ws = split_workspace(x, m, o, nb, *experts)
        split = (0 if ws is None else ws.data_ptr(), splits)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(
            x.data_ptr(), *(t.data_ptr() for t in ptrs), y.data_ptr(),
            *experts, m, o, nb, kb, tb.bn, _DTYPES[x.dtype],
            *((wfmt,) if quant else ()), *split, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{getattr(lib, _ERROR_FN[stem])(err).decode()}")
    LAUNCHES[name] += 1
    return y


def _check(x: Tensor, tb: TiledBalanced, bm: int, bo: int, *,
           batched: bool = False) -> None:
    lead = 1 if batched else 0
    if x.ndim != 2 + lead or tb.indices.ndim != 3 + lead:
        raise ValueError(f"expected x [{'E, ' * lead}M, N] and W "
                         f"[{'E, ' * lead}O, NB, KB], got {tuple(x.shape)} / "
                         f"{tuple(tb.indices.shape)}")
    m, n = x.shape[-2:]
    o, nb, _ = tb.indices.shape[-3:]
    if x.shape[:-2] != tb.indices.shape[:-3] or n != nb * tb.bn or m % bm \
            or o % bo:
        raise ValueError(f"shapes not tile-aligned: x {tuple(x.shape)}, "
                         f"W {tuple(tb.indices.shape)}, bm={bm} bo={bo} "
                         f"bn={tb.bn}")


def tiled_balanced_spmm(x: Tensor, tb: TiledBalanced, *, bm: int = 128,
                        bo: int = 128) -> Tensor:
    """Prefill-shaped tiled matmul.  ``x``: ``[M, NB*bn]``; ``tb``:
    ``[O, NB, KB]`` with ``M % bm == O % bo == 0`` (the caller pads, see
    `ops._pad_and_run_tiled`), quantized or not.  Returns f32 ``[M, O]``."""
    _check(x, tb, bm, bo)
    if x.is_cuda:
        return _launch("tiled_balanced_spmm", x, tb)
    return tiled_balanced_spmm_plain(x, tb)


def tiled_balanced_spmm_skinny(x: Tensor, tb: TiledBalanced, *,
                               bo: int = 128) -> Tensor:
    """Decode-shaped tiled matmul for ``M <= 8`` (the padded decode batch;
    the kernel keeps the whole x block resident).  Returns f32 ``[M, O]``."""
    _check(x, tb, 1, bo)
    if x.shape[0] > SKINNY_MAX_M:
        raise ValueError(f"skinny kernel takes M <= {SKINNY_MAX_M}, got "
                         f"{x.shape[0]}")
    if x.is_cuda:
        return _launch("tiled_balanced_spmm_skinny", x, tb)
    return tiled_balanced_spmm_plain(x, tb)


def tiled_balanced_spmm_batched(x: Tensor, tb: TiledBalanced, *,
                                bm: int = 128, bo: int = 128) -> Tensor:
    """The MoE experts' tiled matmul, every expert in one launch.  ``x``:
    ``[E, M, NB*bn]``; ``tb`` leaves ``[E, O, NB, KB]`` with ``M % bm ==
    O % bo == 0`` (the caller pads, see `ops._TiledSpmmBatched`).  The
    kernel takes its 8-row tile for ``M <= 8`` and its wide tile otherwise.
    Returns f32 ``[E, M, O]``."""
    _check(x, tb, bm, bo, batched=True)
    if x.is_cuda:
        return _launch("tiled_balanced_spmm_batched", x, tb)
    return tiled_balanced_spmm_batched_plain(x, tb)
