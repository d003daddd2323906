"""Mixtral 8x7B [arXiv:2401.04088]: 8 experts top-2, GQA kv=8, sliding-
window attention (Mistral lineage, 4096 window)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    block_pattern=("swa",),
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    shared_expert=False,
    tie_embeddings=False,
    source="arXiv:2401.04088 (hf tier)",
)
