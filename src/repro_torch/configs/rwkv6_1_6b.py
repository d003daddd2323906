"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892]: attention-free, data-dependent
decay time-mix + channel-mix, O(1) decode state."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads (head_dim 64)
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    activation="gelu",  # channel-mix uses its own relu^2; unused elsewhere
    norm="layernorm",
    rope_kind="none",
    block_pattern=("rwkv",),
    tie_embeddings=True,
    source="arXiv:2404.05892 (unverified tier)",
)
