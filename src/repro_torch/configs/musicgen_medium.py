"""musicgen-medium [arXiv:2306.05284; hf] — decoder over EnCodec tokens.

Modality frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings [B, n_frontend_tokens, frontend_dim].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048, head_dim=64,
    norm="rmsnorm", mlp="gelu", frontend="audio", n_frontend_tokens=256,
    frontend_dim=128, w_sparsity=0.5)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
    norm="rmsnorm", mlp="gelu", frontend="audio", n_frontend_tokens=8,
    frontend_dim=16, q_chunk=16, kv_chunk=16, loss_chunk=16)
