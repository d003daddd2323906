"""IBM Granite-4.0-H Micro [hf:ibm-granite/granite-4.0-h-micro]: a hybrid
of 36 Mamba-2 layers and 4 NoPE grouped-query attention layers, one
attention layer in each period of ten (layers 5, 15, 25, 35), every layer
with a SwiGLU MLP; Granite's embedding, residual, attention and logit
multipliers. Port-only: the JAX package has no Mamba-2 block."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-4.0-h-micro",
    family="hybrid",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=100352,
    activation="swiglu",
    norm="rmsnorm",
    rope_kind="none",
    block_pattern=("mamba2",) * 5 + ("attn",) + ("mamba2",) * 4,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_state=128,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.015625,
    logits_scaling=8.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-4.0-h-micro (config.json)",
)
