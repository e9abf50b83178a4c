"""command-r-plus-104b [hf:CohereForAI; unverified] — dense, GQA kv=8, no-bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab_size=256000, head_dim=128,
    norm="rmsnorm", mlp="swiglu", rope_theta=75e4, w_sparsity=0.5,
    grad_accum=8)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=6, n_kv_heads=2, d_ff=192, vocab_size=256, head_dim=16,
    norm="rmsnorm", mlp="swiglu", q_chunk=16, kv_chunk=16, loss_chunk=16)
