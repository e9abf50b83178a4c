"""Sparse convolution: chunked im2col + balanced-sparse GEMM — counterpart
of `repro.kernels.sparse_conv`.

The paper's CONV processing keeps the whole kernel compressed and skips
zero products (§III-C).  Here the convolution lowers to a GEMM over
extracted patches and the contraction runs through the balanced-sparse
kernels (`ops.tiled_spmm` on a plan's encoding, `ops.balanced_spmm` on a
flat one), whose K-per-row invariant comes from the load-balancing pruning
of each Co kernel.

The patch matrix is ``B*Ho*Wo x Ci*Hk*Wk`` — at VGG-16 scale hundreds of
MiB.  `sparse_conv2d` therefore streams it in output-row chunks of at most
`_CHUNK_ELEMS` patch elements (the reference's budget): the input is padded
once, then each chunk extracts the patches of a slab of output rows and
feeds them straight through the GEMM.

The patch matrix's column order is (Ci, Hk, Wk) raster order, Ci-major, from
NHWC input (as XLA's ``conv_general_dilated_patches`` gives it), matching
the flattening of `core.pruning.balanced_prune_conv`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# Patch-chunk budget (elements): bounds the im2col slab at ~8 MiB f32.
_CHUNK_ELEMS = 1 << 21


def _resolve_padding(h: int, w: int, hk: int, wk: int, stride: int,
                     padding) -> tuple[tuple[int, int], tuple[int, int]]:
    """Explicit (lo, hi) pads per spatial dim, matching XLA's SAME/VALID."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        def same(dim, k):
            out = -(-dim // stride)
            total = max((out - 1) * stride + k - dim, 0)
            return total // 2, total - total // 2
        return same(h, hk), same(w, wk)
    raise ValueError(f"unsupported padding {padding!r}")


def _pad_nhwc(x: Tensor, ph: tuple[int, int], pw: tuple[int, int]) -> Tensor:
    if not any(ph + pw):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))


def im2col(x: Tensor, hk: int, wk: int, *, stride: int = 1,
           padding: str | int = "SAME") -> Tensor:
    """x [B,H,W,Ci] -> patches [B, Ho, Wo, Ci*Hk*Wk] (Ci-major column
    order): two strided windows over the padded input, then one copy."""
    b, h, w, ci = x.shape
    xp = _pad_nhwc(x, *_resolve_padding(h, w, hk, wk, stride, padding))
    win = xp.unfold(1, hk, stride).unfold(2, wk, stride)  # [B,Ho,Wo,Ci,Hk,Wk]
    return win.reshape(b, win.shape[1], win.shape[2], ci * hk * wk)


def sparse_conv2d(x: Tensor, values: Tensor, indices: Tensor, n_in: int, *,
                  hk: int, wk: int, stride: int = 1,
                  padding: str | int = "SAME",
                  matmul_fn=None, chunk_elems: int = _CHUNK_ELEMS) -> Tensor:
    """Balanced-sparse conv: x [B,H,W,Ci], kernel (values[Co,K], indices)
    over the flattened (Ci*Hk*Wk) patch axis.  ``matmul_fn(flat, values,
    indices, n_in=)`` defaults to the flat `ops.balanced_spmm` (its
    ``cuda`` rung).

    The im2col GEMM is streamed in output-row chunks of at most
    ``chunk_elems`` patch elements each; pass a huge ``chunk_elems`` to
    force a single piece.
    """
    if matmul_fn is None:
        from . import ops

        def matmul_fn(flat, values, indices, n_in):
            return ops.balanced_spmm(flat, values, indices, n_in=n_in,
                                     impl="cuda")
    b, h, w, ci = x.shape
    feat = ci * hk * wk
    assert feat == n_in, (feat, n_in)
    xp = _pad_nhwc(x, *_resolve_padding(h, w, hk, wk, stride, padding))
    hp, wp = xp.shape[1], xp.shape[2]
    ho = (hp - hk) // stride + 1
    wo = (wp - wk) // stride + 1
    co = values.shape[0]

    rows_per_chunk = max(1, chunk_elems // max(b * wo * feat, 1))
    if rows_per_chunk >= ho:
        patches = im2col(xp, hk, wk, stride=stride, padding="VALID")
        y = matmul_fn(patches.reshape(b * ho * wo, feat), values, indices,
                      n_in=n_in)
        return y.reshape(b, ho, wo, co)

    outs = []
    for r0 in range(0, ho, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, ho)
        slab = xp[:, r0 * stride:(r1 - 1) * stride + hk]
        patches = im2col(slab, hk, wk, stride=stride, padding="VALID")
        y = matmul_fn(patches.reshape(b * (r1 - r0) * wo, feat), values,
                      indices, n_in=n_in)
        outs.append(y.reshape(b, r1 - r0, wo, co))
    return torch.cat(outs, dim=1)
