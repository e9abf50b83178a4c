"""zamba2-1.2b [arXiv:2411.15242; hf] — Mamba2 backbone + shared attn block."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_head_dim=64, attn_every=6,
    w_sparsity=0.5)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_head_dim=16, attn_every=2,
    q_chunk=16, kv_chunk=16, loss_chunk=16, w_sparsity=0.5)
