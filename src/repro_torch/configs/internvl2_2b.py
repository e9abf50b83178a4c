"""internvl2-2b [arXiv:2404.16821; hf] — InternViT (stub) + InternLM2 backbone.

Vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings [B, n_frontend_tokens, frontend_dim].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab_size=92553, head_dim=128,
    frontend="vision", n_frontend_tokens=256, frontend_dim=1024,
    w_sparsity=0.5)

SMOKE = ModelConfig(
    name="internvl2-2b-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    frontend="vision", n_frontend_tokens=8, frontend_dim=32, q_chunk=16,
    kv_chunk=16, loss_chunk=16)
