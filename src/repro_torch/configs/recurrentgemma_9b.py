"""RecurrentGemma-9B [arXiv:2402.19427 Griffin]: RG-LRU recurrent blocks
with local attention, 1 attention : 2 recurrent, MQA (kv=1), window 2048."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    block_pattern=("rglru", "rglru", "swa"),
    sliding_window=2048,
    d_rnn=4096,
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2402.19427 (unverified tier)",
)
