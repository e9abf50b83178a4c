"""In-place KV-cache row writes on the plane layout: the CUDA kernel's
wrappers, their plain PyTorch version and the launch counter —
counterpart of `repro.kernels.kv_cache_update`.

The cache is stored in plane layout ``[P, S, dh]``, a plane being one
(sequence, kv-head) pair: ``P = B * KH`` (plane ``b * KH + h``) for a
contiguous batch, ``P = num_pages * KH`` for the paged pool
(`serving.paged_kv`).  A decode step writes one ``[dh]`` row per plane at
``pos[p]``, a prefill chunk ``C`` rows at ``pos[p] .. pos[p] + C - 1``.

* `kv_cache_update` <- ``kv_cache_update_pallas`` (C = 1) and
  `kv_cache_write_chunk` <- the reference's ``kv_cache_write_chunk`` (its
  XLA twin, C >= 1, the form the model calls): one kernel,
  ``kv_write_rows`` in ``csrc/kv_cache_update.cu``, serves both.

Both write **in place**, as the Pallas kernel's input/output aliasing
does, and return the cache they were given; a non-contiguous cache
raises (a ``.contiguous()`` copy would take the write and be dropped).
Rows at or past ``S`` are dropped, as the reference's ``.at[].set`` drops
an out-of-range update.  On a CUDA tensor the wrappers launch the kernel
or raise; on a CPU tensor they run `kv_cache_write_chunk_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

Tensor = torch.Tensor

# launches of the kernel; counted where it is launched and nowhere else
LAUNCHES = {"kv_cache_update": 0}

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_POS_DTYPES = {torch.int32: 0, torch.int64: 1}


def reset_launches() -> None:
    LAUNCHES["kv_cache_update"] = 0


def to_planes(kv: Tensor) -> Tensor:
    """``[B, S, KH, dh]`` -> plane layout ``[B*KH, S, dh]`` (a copy)."""
    b, s, kh, dh = kv.shape
    return kv.permute(0, 2, 1, 3).reshape(b * kh, s, dh)


def from_planes(planes: Tensor, kh: int) -> Tensor:
    """Plane layout ``[B*KH, S, dh]`` -> ``[B, S, KH, dh]``."""
    p, s, dh = planes.shape
    return planes.reshape(p // kh, kh, s, dh).permute(0, 2, 1, 3)


def kv_cache_write_chunk_plain(cache: Tensor, new: Tensor,
                               pos: Tensor) -> Tensor:
    """The plain version: ``cache[p, pos[p] + i] = new[p, i]`` for every
    row inside ``[0, S)`` by one ``index_put_``, in place; rows outside are
    dropped.  Returns ``cache``."""
    p, c, _ = new.shape
    rows = pos.long()[:, None] + torch.arange(c, device=cache.device)
    keep = (rows >= 0) & (rows < cache.shape[1])
    planes = torch.arange(p, device=cache.device)[:, None].expand(p, c)
    cache.index_put_((planes[keep], rows[keep]),
                     new[keep].to(cache.dtype))
    return cache


def kv_cache_update_plain(cache: Tensor, new: Tensor, pos: Tensor) -> Tensor:
    """The plain version of the C = 1 write (the reference's
    ``kv_cache_update_xla``): ``cache[p, pos[p]] = new[p]``, in place."""
    return kv_cache_write_chunk_plain(cache, new[:, None], pos)


def kv_cache_update_ref(cache: Tensor, new: Tensor, pos: Tensor) -> Tensor:
    """The oracle: the mask-select rewrite of the whole cache (a new
    tensor; the cache is not touched)."""
    s = cache.shape[1]
    mask = (torch.arange(s, device=cache.device)[None, :]
            == pos.long()[:, None])[..., None]
    return torch.where(mask, new[:, None].to(cache.dtype), cache)


def _lib() -> ctypes.CDLL:
    lib = _build.load("kv_cache_update")
    if not getattr(lib, "_typed", False):
        # cache, new, pos; P, S, C, row bytes, pos dtype; stream
        lib.kv_write_rows.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.kv_write_rows.restype = ctypes.c_int
        lib.kv_error_string.argtypes = [ctypes.c_int]
        lib.kv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(cache: Tensor, new: Tensor, pos: Tensor) -> None:
    if cache.dtype not in _DTYPES:
        raise TypeError(f"kv_cache_update: the cache must be float32, "
                        f"bfloat16 or float16, got {cache.dtype}")
    if pos.dtype not in _POS_DTYPES:
        raise TypeError(f"kv_cache_update: pos must be int32 or int64, got "
                        f"{pos.dtype}")
    if new.device != cache.device or pos.device != cache.device:
        raise ValueError("kv_cache_update: cache, new and pos must share one "
                         "CUDA device")
    p, s, dh = cache.shape
    c = new.shape[1]
    new = new.to(cache.dtype).contiguous()
    pos = pos.contiguous()
    lib = _lib()
    with torch.cuda.device(cache.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kv_write_rows(cache.data_ptr(), new.data_ptr(),
                                pos.data_ptr(), p, s, c,
                                dh * cache.element_size(),
                                _POS_DTYPES[pos.dtype], stream)
    if err:
        raise RuntimeError(f"kv_cache_update kernel launch failed: "
                           f"{lib.kv_error_string(err).decode()}")
    LAUNCHES["kv_cache_update"] += 1


def kv_cache_write_chunk(cache: Tensor, new: Tensor, pos: Tensor) -> Tensor:
    """Write ``new`` ``[P, C, dh]`` at ``cache[p, pos[p] + i]`` for
    ``i < C``, in place; rows at or past ``S`` are dropped.  ``cache``:
    ``[P, S, dh]``, contiguous; ``pos``: ``[P]`` int.  Returns ``cache``."""
    if cache.ndim != 3 or new.ndim != 3 or pos.ndim != 1 \
            or new.shape[0] != cache.shape[0] \
            or new.shape[2] != cache.shape[2] \
            or pos.shape[0] != cache.shape[0]:
        raise ValueError(f"expected cache [P, S, dh], new [P, C, dh] and pos "
                         f"[P], got {tuple(cache.shape)} / {tuple(new.shape)}"
                         f" / {tuple(pos.shape)}")
    if not cache.is_contiguous():
        raise ValueError("kv_cache_update writes in place: the cache must be "
                         "contiguous (a copy would take the write)")
    if cache.is_cuda:
        _launch(cache, new, pos)
    else:
        kv_cache_write_chunk_plain(cache, new, pos)
    return cache


def kv_cache_update(cache: Tensor, new: Tensor, pos: Tensor) -> Tensor:
    """Write ``new[p]`` (``[P, dh]``) at ``cache[p, pos[p]]`` in place:
    the contract of ``kv_cache_update_pallas``.  Returns ``cache``."""
    if new.ndim != 2:
        raise ValueError(f"expected new [P, dh], got {tuple(new.shape)}")
    return kv_cache_write_chunk(cache, new[:, None], pos)
