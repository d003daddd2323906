"""IBM Granite-3.0 2B base [hf:ibm-granite/granite-3.0-2b-base]: dense GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    block_pattern=("attn",),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base (hf tier)",
)
