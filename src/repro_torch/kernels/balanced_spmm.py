"""Balanced-sparse x dense matmul on the tile-local format: the CUDA kernels'
wrappers, their plain PyTorch version and their launch counters.

Counterpart of `repro.kernels.balanced_spmm` (Pallas TPU kernels):

* `tiled_balanced_spmm`        <- ``tiled_balanced_spmm_pallas`` (prefill,
  wide M), kernel ``tiled_spmm_wide`` in ``csrc/balanced_spmm.cu``;
* `tiled_balanced_spmm_skinny` <- ``tiled_balanced_spmm_skinny_pallas``
  (decode, M <= 8), kernel ``tiled_spmm_skinny``.

Both compute ``y[M, O] = x[M, NB*bn] @ decode(W)^T`` in f32 and return the
f32 accumulator (the caller casts).  On a CUDA tensor a wrapper launches its
kernel or raises; on a CPU tensor it runs `tiled_balanced_spmm_plain`.
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
LAUNCHES = {"tiled_balanced_spmm": 0, "tiled_balanced_spmm_skinny": 0}

_C_FN = {"tiled_balanced_spmm": "tiled_spmm_wide",
         "tiled_balanced_spmm_skinny": "tiled_spmm_skinny"}
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("balanced_spmm")
    if not getattr(lib, "_typed", False):
        for fn in _C_FN.values():
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
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
    m, _ = x.shape
    o, nb, kb = tb.indices.shape
    if not (4 <= tb.bn <= MAX_BN and tb.bn % 4 == 0 and kb <= MAX_BN):
        raise ValueError(f"{name}: the kernel takes bn a multiple of 4 in "
                         f"[4, {MAX_BN}] and KB <= {MAX_BN}, got bn={tb.bn} "
                         f"KB={kb}")
    x = x.contiguous()
    vals = tb.values.contiguous()
    idx = tb.indices.contiguous()
    y = torch.empty((m, o), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _C_FN[name])(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), y.data_ptr(),
            m, o, nb, kb, tb.bn, _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.spmm_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return y


def _check(x: Tensor, tb: TiledBalanced, bm: int, bo: int) -> None:
    m, n = x.shape
    o, nb, _ = tb.indices.shape
    if n != nb * tb.bn or m % bm or o % bo:
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
