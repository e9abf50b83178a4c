"""Shared model primitives — counterpart of `repro.models.layers` (init
helpers, norms, RoPE, the chunked prefill attention and its unchunked
twin, decode attention, the projections and MLPs, and the chunked LM
loss).  Scores, softmax and the value sum run in f32 and the result is cast back to the activation dtype, as the
reference's ``preferred_element_type=f32`` einsums do.  Masks select with
`torch.where`, never multiply (0 * NaN would poison the output)."""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, n_in: int, n_out: int,
               dtype=torch.float32, device=None) -> Tensor:
    """``[n_in, n_out]`` unit normals over sqrt(n_in), drawn from
    ``generator`` on ``device`` (default: the generator's; ``meta`` draws
    nothing)."""
    w = torch.randn((n_in, n_out), generator=generator,
                    device=device or generator.device)
    return (w * (1.0 / math.sqrt(n_in))).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32, device=None) -> Tensor:
    w = torch.randn((vocab, dim), generator=generator,
                    device=device or generator.device)
    return (w * 0.02).to(dtype)


def _row_mean(x: Tensor) -> Tensor:
    """The mean over the last dim, summed in float64 and rounded to
    float32: a row's mean then does not depend on how many rows share the
    call (the GPU's float32 reductions split a few rows' sums otherwise
    than many rows'), so a live mesh's ranks, which normalize their own
    rows, match one process bit for bit."""
    return x.double().mean(dim=-1, keepdim=True).float()


def rms_norm(x: Tensor, gamma: Tensor | None, *, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(_row_mean(xf.square()) + eps)
    if gamma is not None:
        y = y * gamma
    return y.to(x.dtype)


def layer_norm(x: Tensor, gamma: Tensor | None = None,
               beta: Tensor | None = None, *, eps: float = 1e-5) -> Tensor:
    """LayerNorm; with gamma=beta=None it is OLMo's non-parametric LN.
    Its mean and variance are `_row_mean`'s."""
    xf = x.float()
    mu = _row_mean(xf)
    var = _row_mean((xf - mu).square())
    y = (xf - mu) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y.to(x.dtype)


def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, *,
               theta: float = 10000.0) -> Tensor:
    """x: ``[..., S, H, dh]``; positions: ``[..., S]`` (int)."""
    freqs = rope_frequencies(x.shape[-1], theta=theta, device=x.device)
    angles = positions[..., None].float() * freqs          # [..., S, dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def causal_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal prefill attention as one masked softmax, q ``[B, S, H, dh]``,
    k/v ``[B, S, KH, dh]`` with H = KH * G (grouped, no KV repetition): the
    plain, unchunked twin of `blocked_causal_attention`, which tests and
    the GPU smoke hold it against; no model calls it.  It holds the
    ``[B, KH, G, S, S]`` scores at once.  A non-finite score (a NaN or Inf
    q / k) weighs nothing and a row with no finite score gives zeros.  On
    finite inputs it equals the reference's ``blocked_causal_attention``
    at any chunking; with a non-finite k it does so only when the kv
    sequence is one chunk (see `blocked_causal_attention`), and then not
    where a row holds a NaN score beside a finite one above ~88: the
    reference's ``exp`` overflows there and its row is NaN, this one's is
    finite."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, dh).float()
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(dh)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]                      # [q, k]
    sc = torch.where(mask & torch.isfinite(sc), sc, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)     # rows with no finite score
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def attention_chunks(s: int, q_chunk: int, kv_chunk: int) -> Tuple[int, int]:
    """The chunks a model's prefill attention runs at for sequence ``s``:
    the config's ``q_chunk`` / ``kv_chunk`` capped at ``s``, each halved
    until it divides ``s`` (at least 1), as the reference's models pick
    them.  An odd ``s`` gives chunks of 1."""
    qc, kc = min(q_chunk, s), min(kv_chunk, s)
    while s % qc:
        qc //= 2
    while s % kc:
        kc //= 2
    return max(qc, 1), max(kc, 1)


def _q_block(qc: Tensor, k: Tensor, v: Tensor, q_lo: int, kv_chunk: int,
             causal: bool, scale: float) -> Tensor:
    """One q block of `blocked_causal_attention`: qc ``[B, Cq, KH, G, dh]``
    (f32) against f32 k / v ``[B, S, KH, dh]``; returns ``[B, Cq, KH, G,
    dh]`` f32."""
    b, cq, kh, g, dh = qc.shape
    dev = qc.device
    m = torch.full((b, kh, g, cq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kh, g, cq), dtype=torch.float32, device=dev)
    a = torch.zeros((b, kh, g, cq, dh), dtype=torch.float32, device=dev)
    q_hi = q_lo + cq - 1
    qpos = torch.arange(q_lo, q_lo + cq, device=dev)
    for k_lo in range(0, k.shape[1], kv_chunk):
        # a kv chunk is visible iff its first position <= the block's last
        if causal and k_lo > q_hi:
            break
        kc = k[:, k_lo:k_lo + kv_chunk]
        vc = v[:, k_lo:k_lo + kv_chunk]
        if qc.is_meta:
            # no values on the meta device (the dry run): the two products
            # alone, accumulated so that a backward reaches every chunk,
            # give the shapes and the FLOPs it counts
            a = a + torch.einsum("bhgqk,bkhd->bhgqd",
                                 torch.einsum("bqhgd,bkhd->bhgqk", qc, kc),
                                 vc)
            continue
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
        if causal and k_lo + kv_chunk - 1 > q_lo:
            # the chunk crosses the diagonal (below it the mask is all-true)
            kpos = torch.arange(k_lo, k_lo + kv_chunk, device=dev)
            sc = torch.where(kpos[None, :] <= qpos[:, None], sc,
                             float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(sc - m_safe[..., None])
        p = torch.where(torch.isfinite(sc), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        a = a * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        m = m_new
    out = a / torch.clamp_min(l[..., None], 1e-30)          # [B,KH,G,Cq,dh]
    return out.permute(0, 3, 1, 2, 4)


def blocked_causal_attention(q: Tensor, k: Tensor, v: Tensor, *,
                             q_chunk: int = 512, kv_chunk: int = 1024,
                             causal: bool = True,
                             q_part: Tuple[int, int] = (0, 1)) -> Tensor:
    """Flash-style attention, q ``[B, S, H, dh]``, k/v ``[B, S, KH, dh]``
    with H = KH * G (grouped, no KV repetition) — the reference's
    ``blocked_causal_attention``.  An online softmax over kv chunks inside
    a loop over q chunks, in f32, so the largest score tensor is ``[B, KH,
    G, q_chunk, kv_chunk]``; the chunks must divide S.  A kv chunk that no
    query of the block can see is skipped (the reference's ``lax.cond``
    skips the same chunks).  With gradients on, each q block is recomputed
    in the backward (`torch.utils.checkpoint`, the reference's
    ``jax.checkpoint``), so no score block is kept for it.

    The update is the reference's operation for operation, NaN propagation
    included: a NaN or Inf score makes its chunk's running max non-finite,
    after which every later chunk's correction is 0, so with a poisoned k
    the result depends on the chunking (`causal_attention`, the unchunked
    rule, agrees only when S is one kv chunk).  The reference's ``mesh=``
    argument (sharding constraints) has no counterpart here: on a live
    mesh the transformer splits attention by the cache's planes, and where
    ``model`` splits no plane it splits the query groups (the q heads of
    a plane) or, with ``q_part = (i, n)``, each q chunk's rows into ``n``
    parts of which this call computes part ``i`` (``[B, S / n, H, dh]``,
    chunk by chunk): the reference's query-sequence split of each chunk
    over ``model``.  On the ``meta`` device (`launch.dryrun`) tensors hold
    no values, and only the two products of each computed chunk run."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    part, parts = q_part
    if s % q_chunk or s % kv_chunk or q_chunk % parts:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) must divide the "
                         f"sequence {s}, and {parts} parts the q chunk")
    rows = q_chunk // parts
    scale = 1.0 / math.sqrt(dh)
    qs = q.reshape(b, s, kh, h // kh, dh).float()
    kf, vf = k.float(), v.float()
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for q_lo in range(part * rows, s, q_chunk):
        qc = qs[:, q_lo:q_lo + rows]
        if grad:
            outs.append(checkpoint(_q_block, qc, kf, vf, q_lo, kv_chunk,
                                   causal, scale, use_reentrant=False))
        else:
            outs.append(_q_block(qc, kf, vf, q_lo, kv_chunk, causal, scale))
    return torch.cat(outs, dim=1).reshape(b, s // parts, h, dh).to(q.dtype)


def prefill_attention(q: Tensor, k: Tensor, v: Tensor, *, q_chunk: int,
                      kv_chunk: int, q_part: Tuple[int, int] = (0, 1)
                      ) -> Tensor:
    """The models' prefill (and training) attention: the reference's one
    form, `blocked_causal_attention` at the chunks `attention_chunks`
    picks for the sequence, a one-chunk prompt included."""
    qc, kc = attention_chunks(q.shape[1], q_chunk, kv_chunk)
    return blocked_causal_attention(q, k, v, q_chunk=qc, kv_chunk=kc,
                                    q_part=q_part)


def decode_attention_planes(q: Tensor, k_planes: Tensor, v_planes: Tensor,
                            cache_len: Tensor) -> Tensor:
    """Chunked decode attention on a plane-layout KV cache.

    q: ``[B, C, H, dh]`` — C >= 1 new tokens whose K/V rows were just
    written at ``cache_len .. cache_len + C - 1``; k/v planes ``[B*KH, Smax,
    dh]`` (plane ``b * KH + h``); query i attends to positions
    ``j <= cache_len + i``.

    The scores, the softmax and the weighted sum are taken in float64 and
    the result rounded to q's dtype, so a row's output does not depend on
    how many rows share the call: on the GPU a batched float32 product
    rounds by its batch's size, and a live mesh's ranks decode their rows
    alone yet must match one process bit for bit.
    """
    b, c, h, dh = q.shape
    kh = k_planes.shape[0] // b
    smax = k_planes.shape[1]
    k4 = k_planes.reshape(b, kh, smax, dh).double()
    v4 = v_planes.reshape(b, kh, smax, dh).double()
    qg = q.reshape(b, c, kh, h // kh, dh).double()
    sc = torch.einsum("bqhgd,bhkd->bhgqk", qg, k4) / math.sqrt(dh)
    pos = torch.arange(smax, device=q.device)
    last = cache_len[:, None] + torch.arange(c, device=q.device)[None, :]
    mask = pos[None, None, :] <= last[:, :, None]            # [B, C, Smax]
    sc = torch.where(mask[:, None, None], sc, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v4)
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, dh).to(q.dtype)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_len: Tensor) -> Tensor:
    """Single-token attention on a ``[B, Smax, KH, dh]`` cache (zamba2's
    shared block): q ``[B, 1, H, dh]``; ``cache_len`` ``[B]`` masks the
    slots at and past it.  As the reference's, a plain softmax: a NaN
    score gives a NaN output (a poisoned q / k surfaces here).  Taken in
    float64 and rounded to q's dtype, as `decode_attention_planes`, so a
    row's output does not depend on the rows and heads that share the
    call."""
    b, _, h, dh = q.shape
    kh = k_cache.shape[2]
    qg = q.reshape(b, 1, kh, h // kh, dh).double()
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.double()) \
        * (1.0 / math.sqrt(dh))
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, :] < cache_len[:, None]                # [B, Smax]
    sc = torch.where(mask[:, None, None, None, :], sc, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v_cache.double())
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Projections and MLPs
# ---------------------------------------------------------------------------

def sparse_linear(x: Tensor, sp, *, impl: str = "cuda",
                  block_k: int | None = None) -> Tensor:
    """Balanced-sparse projection ``y = x @ W.T``: ``sp`` is an
    `engine.plan.LayerPlan` (the plan-driven path; ``impl`` / ``block_k``
    are ignored) or a flat `core.pruning.BalancedSparse` (the ad-hoc kernel
    path); `core.sparse_ops.sparse_matmul` dispatches."""
    from ..core.sparse_ops import sparse_matmul
    return sparse_matmul(x, sp, impl=impl, block_k=block_k)


def matmul_f64(x: Tensor, w: Tensor, dtype: torch.dtype) -> Tensor:
    """``x @ w`` summed in float64 and rounded to ``dtype`` once, so a
    row's product does not depend on the rows and columns that share the
    call: cuBLAS picks its reduction by the shape, and on the H100 a bf16
    product of 2 rows and of 4 rounds some elements a bf16 ulp apart,
    which moves a model's logits past the mesh's parity tolerance (a live
    mesh's rank has half the rows or columns of one process)."""
    return (x.double() @ w.double()).to(dtype)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: Tensor, w_in: Tensor, w_out: Tensor) -> Tensor:
    return F.gelu(x @ w_in, approximate="tanh") @ w_out


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _ce_chunk(xc: Tensor, emb: Tensor, lc: Tensor, mc: Tensor,
              z_loss: float) -> Tensor:
    """Summed NLL + z-loss of one sequence chunk, logits in f32."""
    logits = torch.einsum("bsd,vd->bsv", xc.float(), emb.float())
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc.long()[..., None])[..., 0]
    return ((lse - gold) * mc + z_loss * lse.square() * mc).sum()


def chunked_cross_entropy(x: Tensor, emb: Tensor, labels: Tensor, *,
                          chunk: int = 512, z_loss: float = 1e-4,
                          mask: Tensor | None = None,
                          denom: Tensor | None = None) -> Tensor:
    """Mean next-token cross-entropy without holding ``[B, S, V]`` logits:
    x ``[B, S, D]`` final hidden states, emb ``[V, D]`` (tied softmax
    weights), labels ``[B, S]``.  Runs over S in ``chunk`` pieces, each
    recomputed in the backward (`torch.utils.checkpoint`), so no chunk's
    logits are kept for it; ``z_loss`` is the logit-norm stabilizer.  The
    summed loss is divided by ``denom`` where given (a rank of a live
    mesh: the whole batch's token count times the number of ranks that
    repeat these rows), else by the tokens ``mask`` keeps."""
    b, s, d = x.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    ms = torch.ones((b, s), dtype=torch.float32, device=x.device) \
        if mask is None else mask.float()
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(0, s, chunk):
        sl = slice(j, j + chunk)
        loss_sum = loss_sum + checkpoint(_ce_chunk, x[:, sl], emb,
                                         labels[:, sl], ms[:, sl], z_loss,
                                         use_reentrant=False)
    return loss_sum / (ms.sum().clamp(min=1.0) if denom is None else denom)


def causal_lm_labels(tokens: Tensor, pad_id: int = -1) -> Tuple[Tensor,
                                                                Tensor]:
    """Shift tokens for next-token prediction; returns ``(labels, mask)``
    (the mask f32, 0 at the last position and at ``pad_id`` labels)."""
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    if pad_id >= 0:
        mask = mask * (labels != pad_id)
    return labels, mask
