"""Config system: one frozen dataclass covers every assigned architecture.

Each ``configs/<arch>.py`` exports ``CONFIG`` (the exact published dims) and
``SMOKE`` (a reduced same-family config for CPU tests).  ``SHAPES`` defines
the assigned input-shape set; applicability rules live here so the dry-run,
tests and docs all read one source of truth.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "ssm", "hybrid", "moe", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 128
    qk_norm: bool = False
    norm: str = "rmsnorm"            # rmsnorm | nonparam_ln
    mlp: str = "swiglu"              # swiglu | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_mode: str = "scan"           # scan (paper-faithful) | chunked (SSD)
    # --- hybrid (Zamba2): shared attn block applied every N backbone layers
    attn_every: int = 0
    # --- RWKV6 ---
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 32
    # --- modality frontend stubs (assignment: precomputed embeddings) ---
    frontend: str = ""               # "" | "audio" | "vision"
    n_frontend_tokens: int = 0
    frontend_dim: int = 0
    # --- execution knobs ---
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    grad_accum: int = 1              # microbatches per train step
    # ZeRO-3-style explicit per-layer weight gather (bf16, weight-sized)
    # instead of XLA's activation-sized all-reduce resolution (§Perf B)
    zero3_gather: bool = False
    # decode KV-cache write: "mask" (full-cache select, partition-safe) or
    # "scatter" (token-sized write — §Perf C)
    cache_update: str = "mask"
    # --- Sense sparsity integration (the paper's technique on LMs) ---
    w_sparsity: float = 0.0          # balanced K-per-row target for serving
    sparse_serving: bool = False

    @property
    def n_q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, l = self.d_model, self.d_ff, self.n_layers
        emb = self.vocab_size * d
        if self.family == "ssm":          # rwkv6
            att = d * d * 4 + d * self.rwkv_lora_rank * 12
            ffn = 2 * d * f + d * d
            return emb + l * (att + ffn)
        attn = d * (self.n_heads * self.head_dim) * 2 \
            + d * (self.n_kv_heads * self.head_dim) * 2
        if self.mlp == "swiglu":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * f \
                + self.n_shared_experts * 3 * d * f + d * self.n_experts
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state
                         + d_in // self.ssm_head_dim) + d_in * d
            n_attn = max(1, l // max(self.attn_every, 1))
            return emb + l * mamba + (attn + 3 * d * f)  # shared block once
        return emb + l * (attn + ffn)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic attention: run for SSM/hybrid, skip for pure
# full-attention archs (assignment rule; see DESIGN.md §4).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")

# the families served by models/transformer.py (the reference's
# models.api.TRANSFORMER_FAMILIES); ssm (rwkv6) and hybrid (zamba2) have
# their own model modules and planners
TRANSFORMER_FAMILIES = ("dense", "audio", "vlm", "moe")


def shape_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, ("pure full-attention arch: 524k dense KV decode "
                       "exempted by assignment; noted in DESIGN.md §4")
    return True, ""
