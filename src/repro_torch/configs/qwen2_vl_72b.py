"""Qwen2-VL 72B [arXiv:2409.12191]: VLM text backbone with M-RoPE
(temporal/height/width rotary sections). The dynamic-resolution vision
frontend is a STUB per the assignment: input_specs() provides the token
stream plus precomputed M-RoPE position ids (3, B, S)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    rope_kind="mrope",
    block_pattern=("attn",),
    tie_embeddings=False,
    source="arXiv:2409.12191 (hf tier)",
)
