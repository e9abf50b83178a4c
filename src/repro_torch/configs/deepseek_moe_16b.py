"""deepseek-moe-16b [arXiv:2401.06066; hf] — 2 shared + 64 routed top-6."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400, head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, w_sparsity=0.5)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=256, head_dim=16,
    n_experts=8, n_shared_experts=1, top_k=2, q_chunk=16, kv_chunk=16,
    loss_chunk=16, w_sparsity=0.5)
