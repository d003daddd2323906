"""Decoder-only transformer, in PyTorch.

Layers are grouped into superblocks — one repetition of
``cfg.block_pattern`` — with parameters stacked along a leading
``n_super`` axis, exactly as ``repro.models.transformer`` lays them out
(so converted JAX parameters load as they are). Where the reference
scans over that axis with ``lax.scan``, this module loops over it; the
decode and prefill loops write each layer's slice of the stacked cache
in place.

Modes: ``forward`` (full-sequence logits), ``prefill`` (forward + cache
population, last-token logits), ``decode_step`` (one token against the
cache, in place).

This slice ports ``attn`` blocks with a dense FFN (granite-3-2b and its
kin). ``swa``, ``rglru``, ``rwkv``, MoE and encoder-decoder raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models.attention import (
    attention_spec,
    mha,
    mha_decode,
    project_kv,
)
from repro_torch.models.layers import (
    Param,
    apply_mlp,
    apply_norm,
    build_params,
    embed_lookup,
    embed_spec,
    map_tree,
    mlp_spec,
    norm_spec,
    unembed,
)

_NOT_PORTED = {
    "swa": "swa ring caches (gemma3)",
    "rglru": "models/recurrent.py with the rglru kernel (recurrentgemma)",
    "rwkv": "models/recurrent.py with the wkv6 kernel (rwkv6)",
}


def _require_ported(cfg: ModelConfig, kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md: {_NOT_PORTED[kind]})"
        )
    if kind != "attn":
        raise ValueError(f"unknown block kind {kind}")
    if cfg.is_moe:
        raise NotImplementedError("MoE FFNs are not ported yet (ROADMAP.md: MoE)")
    if cfg.encdec:
        raise NotImplementedError(
            "encoder-decoder models are not ported yet (ROADMAP.md: encdec/mrope)"
        )


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def block_spec(cfg: ModelConfig, kind: str) -> Dict:
    _require_ported(cfg, kind)
    d = cfg.d_model
    return {
        "norm1": norm_spec(d, cfg.norm),
        "mixer": attention_spec(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.attn_bias
        ),
        "norm2": norm_spec(d, cfg.norm),
        "ffn": mlp_spec(d, cfg.d_ff, cfg.activation),
    }


def _stack_spec(spec: Any, n: int) -> Any:
    return map_tree(
        lambda p: Param((n,) + p.shape, ("layer",) + p.axes, p.init, p.scale), spec
    )


def model_spec(cfg: ModelConfig) -> Dict:
    spec: Dict[str, Any] = {"embed": embed_spec(cfg.vocab_size, cfg.d_model)}
    if cfg.n_super > 0:
        spec["super"] = [
            _stack_spec(block_spec(cfg, kind), cfg.n_super)
            for kind in cfg.block_pattern
        ]
    spec["tail"] = [block_spec(cfg, kind) for kind in cfg.tail_kinds]
    spec["final_norm"] = norm_spec(cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        spec["lm_head"] = Param(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), scale=0.02
        )
    return spec


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_block_full(
    cfg: ModelConfig,
    kind: str,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    collect: bool,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (x_out, cache_contrib or None)."""
    _require_ported(cfg, kind)
    h = apply_norm(x, p["norm1"], cfg.norm)
    y = mha(
        p["mixer"], h, positions, causal=True, window=None,
        rope_theta=cfg.rope_theta, rope_kind=cfg.rope_kind, impl=cfg.impl,
    )
    contrib = None
    if collect:
        k, v = project_kv(p["mixer"], h, positions, cfg.rope_theta, cfg.rope_kind)
        contrib = {"k": k, "v": v}
    x = x + y
    h2 = apply_norm(x, p["norm2"], cfg.norm)
    x = x + apply_mlp(h2, p["ffn"], cfg.activation)
    return x, contrib


def _apply_block_decode(
    cfg: ModelConfig,
    kind: str,
    p: Dict,
    x: torch.Tensor,  # (B, 1, D)
    cursor: torch.Tensor,  # (B,) int32 absolute position of this token
    cache: Dict,
    active: Optional[torch.Tensor],  # (B,) live-slot bitmap (arena)
    views: Tuple[torch.Tensor, torch.Tensor],  # (kv_pos, kv_valid), shared by layers
) -> torch.Tensor:
    """One token through one block; writes this token's K/V into
    ``cache`` in place."""
    _require_ported(cfg, kind)
    h = apply_norm(x, p["norm1"], cfg.norm)
    k, v = project_kv(p["mixer"], h, cursor[:, None], cfg.rope_theta, cfg.rope_kind)
    kvcache.attn_cache_write(cache, k, v, cursor)
    kv_pos, valid = views
    y = mha_decode(
        p["mixer"], h, cursor, cache["k"], cache["v"], kv_pos, valid,
        window=None, rope_theta=cfg.rope_theta, rope_kind=cfg.rope_kind,
        impl=cfg.impl, active=active,
    )
    x = x + y
    h2 = apply_norm(x, p["norm2"], cfg.norm)
    return x + apply_mlp(h2, p["ffn"], cfg.activation)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    hd = cfg.resolved_head_dim
    cache: Dict[str, Any] = {}
    if cfg.n_super > 0:
        cache["super"] = []
        for kind in cfg.block_pattern:
            _require_ported(cfg, kind)
            shape = (cfg.n_super, batch, max_len, cfg.n_kv_heads, hd)
            cache["super"].append({
                "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            })
    cache["tail"] = []
    for kind in cfg.tail_kinds:
        _require_ported(cfg, kind)
        cache["tail"].append(
            kvcache.attn_cache_init(batch, max_len, cfg.n_kv_heads, hd, cfg.dtype, device)
        )
    return cache


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


class Transformer:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._spec = model_spec(cfg)
        # Per-layer parameter views of the last params tree seen: the
        # decode loop slices the stacked tensors once, not every step.
        self._param_views: Optional[Tuple[Any, List]] = None

    # ----- params -----------------------------------------------------
    def spec(self):
        return self._spec

    def init(self, generator: torch.Generator, dtype=None, device="cuda"):
        """Random parameters drawn from ``generator`` (on ``device``)."""
        return build_params(self._spec, generator, dtype or self.cfg.dtype, device)

    def _layers(self, params) -> List[Tuple[str, Dict, Tuple]]:
        """[(kind, layer params, where)] in depth order: superblock i at
        pattern position j (``where = ("super", j, i)``), then tail layer t
        (``("tail", t, None)``)."""
        if self._param_views is not None and self._param_views[0] is params:
            return self._param_views[1]
        cfg = self.cfg
        out = []
        for i in range(cfg.n_super):
            for j, kind in enumerate(cfg.block_pattern):
                layer = map_tree(lambda t: t[i], params["super"][j])
                out.append((kind, layer, ("super", j, i)))
        for t, (p_layer, kind) in enumerate(zip(params["tail"], cfg.tail_kinds)):
            out.append((kind, p_layer, ("tail", t, None)))
        self._param_views = (params, out)
        return out

    @staticmethod
    def _cache_view(cache, where) -> Dict[str, torch.Tensor]:
        """One layer's K/V: views into the stacked cache, written in place."""
        part, j, i = where
        if part == "tail":
            return cache["tail"][j]
        return {"k": cache["super"][j]["k"][i], "v": cache["super"][j]["v"][i]}

    def _embed(self, params, tokens):
        x = embed_lookup(params["embed"], tokens)
        if self.cfg.embed_scale:
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def _logits(self, params, x):
        x = apply_norm(x, params["final_norm"], self.cfg.norm)
        if self.cfg.tie_embeddings:
            return unembed(x, params["embed"])
        return x.float() @ params["lm_head"].float()

    # ----- forward ------------------------------------------------------
    def forward(
        self, params, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) integer; positions: (B, S). Returns (logits f32,
        aux) — aux is 0 (no MoE in this slice)."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self._embed(params, tokens)
        for kind, p, _ in self._layers(params):
            x, _ = _apply_block_full(self.cfg, kind, p, x, positions, collect=False)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(params, x), aux

    # ----- decode ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return init_cache(self.cfg, batch, max_len, device)

    def decode_step(
        self,
        params,
        cache,
        token: torch.Tensor,  # (B,) integer
        cursor: torch.Tensor,  # (B,) int32 absolute position of this token
        active: Optional[torch.Tensor] = None,  # (B,) bool live-slot bitmap
    ) -> Tuple[torch.Tensor, Any]:
        """One-token decode: returns (logits (B, V) f32, cache). The cache
        is updated IN PLACE (the returned tree is the one passed in).

        ``active`` marks live slot-arena rows: dead rows are masked out of
        attention (the kernel skips all their KV tiles) and their logits
        are unspecified — the engine never reads them. ``None`` means
        every row is live.
        """
        x = self._embed(params, token[:, None])
        views = None
        for kind, p, where in self._layers(params):
            layer_cache = self._cache_view(cache, where)
            if views is None:
                _, _, kv_pos, valid = kvcache.attn_cache_views(layer_cache, cursor)
                views = (kv_pos, valid)
            x = _apply_block_decode(
                self.cfg, kind, p, x, cursor, layer_cache, active, views
            )
        return self._logits(params, x)[:, 0], cache

    # ----- prefill (forward + cache population) ----------------------------
    def prefill(
        self, params, cache, tokens: torch.Tensor, positions=None
    ) -> Tuple[torch.Tensor, Any]:
        """Left-aligned prefill: fills caches for positions [0, S) in place
        and returns (last-token logits (B, V), cache)."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self._embed(params, tokens)
        for kind, p, where in self._layers(params):
            layer_cache = self._cache_view(cache, where)
            x, contrib = _apply_block_full(self.cfg, kind, p, x, positions, True)
            layer_cache["k"][:, :s] = contrib["k"].to(layer_cache["k"].dtype)
            layer_cache["v"][:, :s] = contrib["v"].to(layer_cache["v"].dtype)
        return self._logits(params, x[:, -1:])[:, 0], cache
