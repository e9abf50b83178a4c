"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf] — 128e top-8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab_size=151936, head_dim=128,
    qk_norm=True, n_experts=128, n_shared_experts=0, top_k=8,
    rope_theta=1e6, w_sparsity=0.5, grad_accum=8,
    param_dtype="bfloat16")

SMOKE = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
    qk_norm=True, n_experts=8, n_shared_experts=0, top_k=2, q_chunk=16,
    kv_chunk=16, loss_chunk=16)
