"""Phi-4-mini 3.8B [arXiv:2412.08905]: dense, RoPE + SwiGLU + GQA, 200k vocab."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    block_pattern=("attn",),
    tie_embeddings=True,
    source="arXiv:2412.08905 (hf tier)",
)
