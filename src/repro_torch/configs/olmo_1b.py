"""olmo-1b [arXiv:2402.00838; hf] — dense, non-parametric LN."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=8192, vocab_size=50304, head_dim=128,
    norm="nonparam_ln", mlp="swiglu", w_sparsity=0.5)

SMOKE = ModelConfig(
    name="olmo-1b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
    norm="nonparam_ln", mlp="swiglu", q_chunk=16, kv_chunk=16, loss_chunk=16)
