"""Gemma-3 12B [hf:google/gemma-3 family]: dense, 5 local : 1 global
attention pattern, 1024-token sliding window on locals, 262k vocab,
GeGLU + sqrt(d) embedding scaling (gemma lineage)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    sliding_window=1024,
    tie_embeddings=True,
    embed_scale=True,
    source="hf:google/gemma-3-1b-pt scaled per assignment (unverified tier)",
)
