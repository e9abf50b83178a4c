"""rwkv6-3b "Finch" [arXiv:2404.05892; hf] — attn-free, data-dependent decay."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560, d_ff=8960,
    vocab_size=65536, rwkv_head_dim=64, rwkv_lora_rank=64, w_sparsity=0.5)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke", family="ssm", n_layers=2, d_model=64, d_ff=128,
    vocab_size=256, rwkv_head_dim=16, rwkv_lora_rank=8, loss_chunk=16,
    w_sparsity=0.5)
