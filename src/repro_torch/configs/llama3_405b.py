"""Llama-3.1 405B [arXiv:2407.21783]: dense, GQA kv=8, 128k vocab."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=500000.0,
    block_pattern=("attn",),
    tie_embeddings=False,
    source="arXiv:2407.21783 (unverified tier)",
)
