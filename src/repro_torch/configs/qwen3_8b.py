"""qwen3-8b [hf:Qwen/Qwen3-8B; hf] — dense, qk_norm, GQA kv=8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, norm="rmsnorm", mlp="swiglu", rope_theta=1e6,
    w_sparsity=0.5)

SMOKE = ModelConfig(
    name="qwen3-8b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, qk_norm=True,
    norm="rmsnorm", mlp="swiglu", q_chunk=16, kv_chunk=16, loss_chunk=16)
