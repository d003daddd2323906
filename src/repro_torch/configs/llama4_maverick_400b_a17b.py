"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4 family]: MoE with 128
routed experts, top-1 routing + shared expert, GQA kv=8. The multimodal
early-fusion frontend is out of scope (text backbone per assignment)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=500000.0,
    block_pattern=("attn",),
    n_experts=128,
    top_k=1,
    shared_expert=True,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E scaled per assignment (unverified tier)",
)
