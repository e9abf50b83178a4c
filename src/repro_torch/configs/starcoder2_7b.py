"""starcoder2-7b [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, d_ff=18432, vocab_size=49152, head_dim=128,
    norm="rmsnorm", mlp="gelu", rope_theta=1e5, w_sparsity=0.5)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke", family="dense", n_layers=2, d_model=72,
    n_heads=6, n_kv_heads=2, d_ff=144, vocab_size=256, head_dim=12,
    norm="rmsnorm", mlp="gelu", q_chunk=16, kv_chunk=16, loss_chunk=16)
