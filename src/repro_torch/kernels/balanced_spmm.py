"""Balanced-sparse x dense matmul on the tile-local format: the CUDA kernels'
wrappers, their plain PyTorch version and their launch counters.

Counterpart of `repro.kernels.balanced_spmm` (Pallas TPU kernels):

* `tiled_balanced_spmm`        <- ``tiled_balanced_spmm_pallas`` (prefill,
  wide M), kernel ``tiled_spmm_wide`` in ``csrc/balanced_spmm.cu``;
* `tiled_balanced_spmm_skinny` <- ``tiled_balanced_spmm_skinny_pallas``
  (decode, M <= 8), kernel ``tiled_spmm_skinny``;
* `tiled_balanced_spmm_batched` <- ``tiled_balanced_spmm_batched_pallas``
  (the MoE experts, one launch over the expert grid), kernel
  ``tiled_spmm_batched``.

They compute ``y[M, O] = x[M, NB*bn] @ decode(W)^T`` (per expert for the
batched one) in f32 and return the f32 accumulator (the caller casts).  On
a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs `tiled_balanced_spmm_plain` / `tiled_balanced_spmm_batched_plain`.
There is no fallback from the kernel to the plain version.  W is an
encoding as `tile_format.encode_tiled` makes it: the nonzero slots of one
row and block hold distinct columns (the kernels store them, see the
source note).

The source note in ``csrc/balanced_spmm.cu`` gives each kernel's bound on
an H100 and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .tile_format import TiledBalanced, _require_unquantized

Tensor = torch.Tensor

# launches per kernel; counted where the kernel is launched and nowhere else
LAUNCHES = {"tiled_balanced_spmm": 0, "tiled_balanced_spmm_skinny": 0,
            "tiled_balanced_spmm_batched": 0}

_C_FN = {"tiled_balanced_spmm": "tiled_spmm_wide",
         "tiled_balanced_spmm_skinny": "tiled_spmm_skinny",
         "tiled_balanced_spmm_batched": "tiled_spmm_batched"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SKINNY_MAX_M = 8
MAX_BN = 128      # widest column block (and block capacity) the kernels take


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tiled_balanced_spmm_plain(x: Tensor, tb: TiledBalanced) -> Tensor:
    """The plain version of both kernels: scatter-add every block's slots
    into a dense f32 ``[O, NB*bn]`` weight (pad slots add 0), then one f32
    matmul.  Returns f32 ``[M, O]``."""
    o, nb, kb = tb.indices.shape
    cols = (torch.arange(nb, device=x.device)[:, None] * tb.bn
            + tb.indices.long()).reshape(o, nb * kb)
    w = torch.zeros((o, nb * tb.bn), dtype=torch.float32, device=x.device)
    w.scatter_add_(1, cols, tb.values.reshape(o, nb * kb).float())
    return x.float() @ w.T


def tiled_balanced_spmm_batched_plain(x: Tensor, tb: TiledBalanced) -> Tensor:
    """The plain version of the batched kernel: every expert's slots
    scatter-added into a dense f32 ``[E, O, NB*bn]`` weight, then one f32
    batched matmul.  ``x``: ``[E, M, NB*bn]``; returns f32 ``[E, M, O]``."""
    e, o, nb, kb = tb.indices.shape
    cols = (torch.arange(nb, device=x.device)[:, None] * tb.bn
            + tb.indices.long()).reshape(e, o, nb * kb)
    w = torch.zeros((e, o, nb * tb.bn), dtype=torch.float32, device=x.device)
    w.scatter_add_(2, cols, tb.values.reshape(e, o, nb * kb).float())
    return torch.bmm(x.float(), w.transpose(1, 2))


def _lib() -> ctypes.CDLL:
    lib = _build.load("balanced_spmm")
    if not getattr(lib, "_typed", False):
        for name, fn in _C_FN.items():
            f = getattr(lib, fn)
            n_int = 7 if name == "tiled_balanced_spmm_batched" else 6
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int \
                + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.spmm_error_string.argtypes = [ctypes.c_int]
        lib.spmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(name: str, x: Tensor, tb: TiledBalanced) -> Tensor:
    _require_unquantized(tb)
    if x.dtype not in _DTYPES or tb.values.dtype != x.dtype:
        raise TypeError(f"{name}: x and values must share float32 or "
                        f"bfloat16, got {x.dtype} / {tb.values.dtype}")
    if tb.indices.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got "
                        f"{tb.indices.dtype}")
    if not (tb.values.device == tb.indices.device == x.device):
        raise ValueError(f"{name}: x, values and indices must share one "
                         "CUDA device")
    batched = name == "tiled_balanced_spmm_batched"
    m = x.shape[-2]
    o, nb, kb = tb.indices.shape[-3:]
    if not (4 <= tb.bn <= MAX_BN and tb.bn % 4 == 0 and kb <= MAX_BN):
        raise ValueError(f"{name}: the kernel takes bn a multiple of 4 in "
                         f"[4, {MAX_BN}] and KB <= {MAX_BN}, got bn={tb.bn} "
                         f"KB={kb}")
    x = x.contiguous()
    vals = tb.values.contiguous()
    idx = tb.indices.contiguous()
    y = torch.empty((*x.shape[:-2], m, o), dtype=torch.float32,
                    device=x.device)
    lib = _lib()
    experts = (x.shape[0],) if batched else ()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _C_FN[name])(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), y.data_ptr(),
            *experts, m, o, nb, kb, tb.bn, _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.spmm_error_string(err).decode()}")
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
    `ops._pad_and_run_tiled`).  Returns f32 ``[M, O]``."""
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
