"""Whisper large-v3 [arXiv:2212.04356]: encoder-decoder, 32+32 layers,
LayerNorm + GELU + attention biases, MHA (kv = heads = 20). The conv/mel
frontend is a STUB per the assignment: input_specs() provides precomputed
frame embeddings (B, T, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    n_layers=32,  # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    norm="layernorm",
    rope_kind="none",
    block_pattern=("attn",),
    encdec=True,
    attn_bias=True,
    tie_embeddings=True,
    source="arXiv:2212.04356 (unverified tier)",
)
