"""Bitmap-compressed sparse x dense matmul, ``y = x @ W.T``: the encoder,
the CUDA kernel's wrapper, its plain PyTorch version and its launch
counter — counterpart of `repro.kernels.bitmap_spmm`.

W ``[O, N]`` is stored as ``(bitmap, packed, offsets)``: a one-byte
bitmap ``[O, N]`` (nonzero = a stored element), each row's nonzeros packed
to the front of ``packed [O, K]`` in raster order (zero padded past the
row's count), and ``offsets [O, N / bn]`` int32, the number of a row's
nonzeros before each column block.  Element ``(r, c)`` of column block
``nb`` decodes as

    pos = offsets[r, nb] + (set bits of bitmap[r] in block nb up to and
          including c) - 1, clipped to [0, K)
    w   = packed[r, pos] if bitmap[r, c] != 0 else 0

* `bitmap_spmm` <- ``bitmap_spmm_pallas``: entry ``bitmap_spmm`` in
  ``csrc/bitmap_spmm.cu``; M > 8 in bf16 runs the tensor-core kernel,
  split as the tiled one (`balanced_spmm.split_workspace`), float32 the
  FMA wide kernel, M <= 8 the skinny one.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `bitmap_spmm_plain`.  The source note in
``csrc/bitmap_spmm.cu`` gives the kernel's bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .balanced_spmm import split_workspace

Tensor = torch.Tensor

# launches of the kernel; counted where it is launched and nowhere else
LAUNCHES = {"bitmap_spmm": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BN = 128      # widest column block the kernel takes


def reset_launches() -> None:
    LAUNCHES["bitmap_spmm"] = 0


def bitmap_encode(w: Tensor, bn: int,
                  k: int | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """Encode a dense ``[O, N]`` matrix into ``(bitmap int8, packed
    [O, Kmax], offsets [O, N/bn] int32)``, array-equal to the reference's
    encoder.  ``Kmax`` is the largest row count (every row of a balanced
    pruned matrix has exactly that many: no padding), at least 1.  A
    static ``k`` sets the packed width instead and raises if a row holds
    more nonzeros than ``k``."""
    o, n = w.shape
    if n % bn:
        raise ValueError(f"N = {n} must be a multiple of bn = {bn}")
    bits = w != 0
    counts = bits.sum(dim=1)
    true_max = int(counts.max()) if o else 0
    if k is None:
        kmax = true_max
    else:
        kmax = int(k)
        if true_max > kmax:
            raise ValueError(
                f"static k={kmax} < max row NZE count {true_max}: "
                "packed would silently truncate nonzeros")
    kmax = max(kmax, 1)
    # the nonzeros to the front of each row, in column order (stable)
    order = torch.argsort((~bits).to(torch.uint8), dim=1, stable=True)
    packed = w.gather(1, order)[:, :kmax]
    valid = torch.arange(kmax, device=w.device)[None, :] < counts[:, None]
    packed = torch.where(valid, packed, packed.new_zeros(()))
    per_block = bits.reshape(o, n // bn, bn).sum(dim=2)
    offsets = torch.cat(
        [torch.zeros((o, 1), dtype=torch.int32, device=w.device),
         torch.cumsum(per_block, dim=1).to(torch.int32)[:, :-1]], dim=1)
    return bits.to(torch.int8), packed, offsets


def bitmap_decode(bitmap: Tensor, packed: Tensor, offsets: Tensor,
                  bn: int) -> Tensor:
    """The kernel's decode, block by block from the offsets, as a dense
    ``[O, N]`` matrix in packed's dtype."""
    o, n = bitmap.shape
    bits = bitmap != 0
    incl = torch.cumsum(bits.reshape(o, n // bn, bn).int(), dim=2)
    pos = (offsets[:, :, None] + incl - 1).reshape(o, n)
    pos = pos.clamp(0, packed.shape[1] - 1).long()
    return torch.where(bits, packed.gather(1, pos), packed.new_zeros(()))


def bitmap_spmm_plain(x: Tensor, bitmap: Tensor, packed: Tensor,
                      offsets: Tensor, *, bn: int) -> Tensor:
    """The plain version of the kernel: `bitmap_decode`, then one f32
    matmul.  Returns f32 ``[M, O]``."""
    w = bitmap_decode(bitmap, packed, offsets, bn)
    return x.float() @ w.float().T


def _check(x: Tensor, bitmap: Tensor, packed: Tensor, offsets: Tensor,
           bn: int) -> None:
    if x.ndim != 2 or bitmap.ndim != 2 or packed.ndim != 2 \
            or offsets.ndim != 2:
        raise ValueError("expected x [M, N], bitmap [O, N], packed [O, K] "
                         "and offsets [O, N/bn]")
    m, n = x.shape
    o = bitmap.shape[0]
    if bitmap.shape[1] != n or n % bn or packed.shape[0] != o \
            or tuple(offsets.shape) != (o, n // bn) or packed.shape[1] < 1:
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, bitmap "
                         f"{tuple(bitmap.shape)}, packed "
                         f"{tuple(packed.shape)}, offsets "
                         f"{tuple(offsets.shape)}, bn={bn}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("bitmap_spmm")
    if not getattr(lib, "_typed", False):
        # x, bitmap, packed, offsets, y; M, O, N, K, bn, dtype; ws,
        # splits; stream
        lib.bitmap_spmm.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.bitmap_spmm.restype = ctypes.c_int
        lib.bitmap_error_string.argtypes = [ctypes.c_int]
        lib.bitmap_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(x: Tensor, bitmap: Tensor, packed: Tensor, offsets: Tensor,
            bn: int) -> Tensor:
    if x.dtype not in _DTYPES or packed.dtype != x.dtype:
        raise TypeError(f"bitmap_spmm: x must be float32 or bfloat16 and "
                        f"share it with packed, got {x.dtype} / "
                        f"{packed.dtype}")
    if bitmap.dtype != torch.int8 or offsets.dtype != torch.int32:
        raise TypeError(f"bitmap_spmm: bitmap must be int8 and offsets "
                        f"int32, got {bitmap.dtype} / {offsets.dtype}")
    if any(t.device != x.device for t in (bitmap, packed, offsets)):
        raise ValueError("bitmap_spmm: x, bitmap, packed and offsets must "
                         "share one CUDA device")
    if not (4 <= bn <= MAX_BN and bn % 4 == 0):
        raise ValueError(f"bitmap_spmm: the kernel takes bn a multiple of 4 "
                         f"in [4, {MAX_BN}], got {bn}")
    m, n = x.shape
    o, k = packed.shape
    x, bitmap, packed, offsets = (t.contiguous()
                                  for t in (x, bitmap, packed, offsets))
    y = torch.empty((m, o), dtype=torch.float32, device=x.device)
    splits, ws = split_workspace(x, m, o, n // bn)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bitmap_spmm(x.data_ptr(), bitmap.data_ptr(),
                              packed.data_ptr(), offsets.data_ptr(),
                              y.data_ptr(), m, o, n, k, bn, _DTYPES[x.dtype],
                              0 if ws is None else ws.data_ptr(), splits,
                              stream)
    if err:
        raise RuntimeError(f"bitmap_spmm kernel launch failed: "
                           f"{lib.bitmap_error_string(err).decode()}")
    LAUNCHES["bitmap_spmm"] += 1
    return y


def bitmap_spmm(x: Tensor, bitmap: Tensor, packed: Tensor, offsets: Tensor,
                *, bn: int = 128) -> Tensor:
    """``y = x @ W.T`` for W bitmap-compressed with column blocks of
    ``bn``.  ``x``: ``[M, N]``; any M and O (the kernel masks the ragged
    edge; `ops.bitmap_spmm` pads as the reference does).  Returns f32
    ``[M, O]``."""
    _check(x, bitmap, packed, offsets, bn)
    if x.is_cuda:
        return _launch(x, bitmap, packed, offsets, bn)
    return bitmap_spmm_plain(x, bitmap, packed, offsets, bn=bn)
