"""Architecture registry: 10 assigned configs + tiny smoke variants.

Each full config matches the assignment exactly; ``tiny()`` produces a
same-family reduced config (few layers, small width, few experts, small
vocab) for CPU smoke tests. The FULL configs are exercised only by the
dry-run (ShapeDtypeStruct lowering — never allocated).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3_405b import CONFIG as llama3_405b
from repro_torch.configs.granite_3_2b import CONFIG as granite_3_2b
from repro_torch.configs.phi4_mini_3_8b import CONFIG as phi4_mini_3_8b
from repro_torch.configs.gemma3_12b import CONFIG as gemma3_12b
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as llama4_maverick
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.recurrentgemma_9b import CONFIG as recurrentgemma_9b
from repro_torch.configs.qwen2_vl_72b import CONFIG as qwen2_vl_72b
from repro_torch.configs.whisper_large_v3 import CONFIG as whisper_large_v3
from repro_torch.configs.rwkv6_1_6b import CONFIG as rwkv6_1_6b

ARCHS: Dict[str, ModelConfig] = {
    c.arch_id: c
    for c in [
        llama3_405b,
        granite_3_2b,
        phi4_mini_3_8b,
        gemma3_12b,
        llama4_maverick,
        mixtral_8x7b,
        recurrentgemma_9b,
        qwen2_vl_72b,
        whisper_large_v3,
        rwkv6_1_6b,
    ]
}


def get_config(arch_id: str, **overrides) -> ModelConfig:
    cfg = ARCHS[arch_id]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def tiny(arch_id: str, **overrides) -> ModelConfig:
    """Same-family reduced config for CPU smoke tests and examples."""
    cfg = ARCHS[arch_id]
    pattern = cfg.block_pattern
    n_layers = max(len(pattern), 2)
    if len(pattern) > 4:  # gemma3's 6-layer pattern: keep one full unit
        n_layers = len(pattern)
    changes = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        d_rnn=64 if cfg.d_rnn else None,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        sliding_window=min(cfg.sliding_window, 16),
        n_encoder_layers=2 if cfg.encdec else 0,
        max_dec_positions=128,
        param_dtype="float32",
        remat=False,
        scan_layers=True,
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM pool (seq_len, global_batch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    """Which of the four assigned shapes run for this arch (skips are
    documented in DESIGN.md §4: long_500k only for sub-quadratic archs)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
