"""ModelConfig: the single description every subsystem consumes.

``block_pattern`` is the repeating unit of layer kinds; it tiles to
``n_layers`` (a non-divisible remainder becomes unscanned tail layers).
Kinds: ``attn`` (global attention), ``swa`` (sliding window), ``rglru``
(Griffin recurrent block), ``rwkv`` (RWKV-6 time-mix block), ``mamba2``
(Mamba-2 state-space mixer, ``ssm_*`` sizes).

The multipliers (``embedding_multiplier``, ``residual_multiplier``,
``attention_multiplier``, ``logits_scaling``) and ``norm_eps`` default to
the plain Llama-style arithmetic the reference computes (no scaling,
1/sqrt(head_dim), the norm kind's own eps), bit for bit; Granite's
published configs set them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 500000.0
    rope_kind: str = "rope"  # rope | mrope | none
    block_pattern: Tuple[str, ...] = ("attn",)
    sliding_window: int = 4096
    d_rnn: Optional[int] = None  # Griffin recurrent width
    # Mamba-2 (``mamba2`` blocks): ``ssm_heads`` heads of ``ssm_head_dim``
    # channels (the inner width), a ``ssm_state``-wide state per channel, B
    # and C one group shared by every head; the causal depthwise conv is 4
    # wide (``models/mamba2.CONV_WIDTH``).
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_state: int = 128
    # Granite's multipliers; the defaults change nothing.
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None  # None: 1 / sqrt(head_dim)
    logits_scaling: float = 1.0
    norm_eps: Optional[float] = None  # None: 1e-6 (rmsnorm), 1e-5 (layernorm)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    # Dense MoE: every token through every expert (no dispatch). Viable
    # for small expert counts (mixtral: 4x active FLOPs) where the
    # dispatch collectives cost far more than the extra compute — the
    # training-side workaround for the shard_map-grad XLA limitation.
    moe_dense: bool = False
    # Encoder-decoder (whisper)
    encdec: bool = False
    n_encoder_layers: int = 0
    max_dec_positions: int = 65536  # learned decoder positions (whisper)
    attn_bias: bool = False
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma-style sqrt(d_model) input scaling
    # Compilation / runtime
    scan_layers: bool = True
    # xla | pallas: attention through repro_torch.kernels.ops (the Hopper
    # kernel for a CUDA tensor, the plain version for a CPU tensor);
    # dense: the plain PyTorch path on any device.
    impl: str = "xla"
    param_dtype: str = "bfloat16"
    remat: bool = True  # activation checkpointing over layer blocks
    # Notes for DESIGN/EXPERIMENTS provenance
    source: str = ""

    # ----- derived -------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def pattern_layers(self) -> Tuple[str, ...]:
        reps = self.n_layers // len(self.block_pattern)
        tail = self.n_layers - reps * len(self.block_pattern)
        return self.block_pattern * reps + self.block_pattern[:tail]

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        reps = self.n_super
        return self.pattern_layers[reps * len(self.block_pattern):]

    @property
    def ssm_inner(self) -> int:
        """A Mamba-2 block's inner width (its heads times their width)."""
        return self.ssm_heads * self.ssm_head_dim

    @property
    def ssm_conv_dim(self) -> int:
        """Channels of a Mamba-2 block's conv: x, then B and C."""
        return self.ssm_inner + 2 * self.ssm_state

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.param_dtype]

    @property
    def attention_free(self) -> bool:
        return all(k in ("rglru", "rwkv", "mamba2") for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when no block kind does full-length global attention, or
        global layers are rare enough that a 500k cache is bounded for the
        majority of layers (gemma3's 5:1 local:global still qualifies for
        the long_500k decode shape per DESIGN.md §4)."""
        kinds = set(self.pattern_layers)
        if "attn" not in kinds:
            return True
        # Hybrid local:global with at most 1 global per pattern unit.
        return (
            self.block_pattern.count("attn") <= 1 and len(self.block_pattern) >= 3
        )

    def param_count_estimate(self) -> int:
        """Rough parameter count (for 6ND model-FLOPs accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        out = v * d if self.tie_embeddings else 2 * v * d
        total = out
        for kind in self.pattern_layers:
            if kind in ("attn", "swa"):
                total += attn
            elif kind == "rglru":
                dr = self.d_rnn or d
                total += 2 * d * dr + 2 * dr * dr + dr * d
            elif kind == "rwkv":
                total += 4 * d * d + d * d  # r,k,v,g,o
            elif kind == "mamba2":
                di = self.ssm_inner
                total += d * (di + self.ssm_conv_dim + self.ssm_heads) + di * d
            if self.is_moe and kind in ("attn", "swa"):
                total += 3 * self.n_experts * d * f
                if self.shared_expert:
                    total += 3 * d * f
            elif kind == "rwkv":
                total += 2 * d * f + d * d  # channel mix
            else:
                total += (3 if self.activation in ("swiglu", "geglu") else 2) * d * f
        if self.encdec:
            # encoder layers: attn + mlp (+ cross-attn on decoder side
            # already counted via pattern_layers = decoder layers)
            enc = self.n_encoder_layers * (attn + 2 * d * f)
            cross = self.n_layers * attn
            total += enc + cross
        return int(total)

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count_estimate()
        d, f = self.d_model, self.d_ff
        total = self.param_count_estimate()
        moe_layers = sum(1 for k in self.pattern_layers if k in ("attn", "swa"))
        inactive = 3 * (self.n_experts - self.top_k) * d * f * moe_layers
        return int(total - inactive)
