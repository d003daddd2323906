"""Decoder-only transformer, in PyTorch.

Layers are grouped into superblocks — one repetition of
``cfg.block_pattern`` — with parameters stacked along a leading
``n_super`` axis, exactly as ``repro.models.transformer`` lays them out
(so converted JAX parameters load as they are). Where the reference
scans over that axis with ``lax.scan``, this module loops over it; the
decode and prefill loops write each layer's slice of the stacked cache
in place.

Modes: ``forward`` (full-sequence logits), ``loss`` (the reference's
next-token loss over ``forward``), ``prefill`` (forward + cache
population, last-token logits), ``decode_step`` (one token against the
cache, in place).

Training: when ``cfg.remat`` is set and autograd is recording, each layer
of ``forward`` runs under ``torch.utils.checkpoint`` (non-reentrant): its
activations are recomputed in the backward pass, the counterpart of the
reference's ``jax.checkpoint`` over each superblock (on a mesh the
recompute re-enters the forward's mode, ``sharding_hooks.remat_contexts``). Per-layer parameter
views are cut from the stacked tensors by one ``unbind`` per leaf, so the
backward gathers a stacked leaf's gradient with one stack, not one
full-size gradient per layer; they are cached (for decode) only while no
gradient is recorded.

Block kinds: ``attn`` (global attention), ``swa`` (sliding-window
attention over a ring cache), ``rglru`` (Griffin recurrent block) and
``rwkv`` (RWKV-6 time-mix with its channel-mix as the FFN). An ``attn``
or ``swa`` block's FFN is dense, or a mixture of experts
(``models/moe.py``) when the config has experts.

M-RoPE models (qwen2-vl) take ``(3, B, S)`` positions in ``forward`` and
``prefill`` (temporal, height, width streams; the vision frontend that
makes them is a stub, as in the reference) and raise without them; decode
rotates by ``mrope_position`` (3, B, 1), the cursor on all three streams
by default. Encoder-decoder models (whisper) live in ``encdec.py``;
``repro_torch.models.model_for`` dispatches.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
    abstract_params,
    apply_mlp,
    apply_norm,
    build_axes,
    build_params,
    embed_lookup,
    embed_spec,
    map_tree,
    mlp_spec,
    norm_spec,
    unembed,
)
from repro_torch.models.moe import apply_moe, apply_moe_dense_reference, moe_spec
from repro_torch.models.recurrent import (
    griffin_block,
    griffin_block_spec,
    griffin_init_state,
    rwkv6_channelmix,
    rwkv6_channelmix_spec,
    rwkv6_init_state,
    rwkv6_timemix,
    rwkv6_timemix_spec,
)
from repro_torch.models.sharding_hooks import constrain, remat_contexts

KINDS = ("attn", "swa", "rglru", "rwkv")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind}")


def _positions(cfg: ModelConfig, tokens: torch.Tensor, positions) -> torch.Tensor:
    """The positions a full-sequence pass runs at: arange by default,
    given ones as they are; an M-RoPE model needs its (3, B, S) streams."""
    b, s = tokens.shape
    if cfg.rope_kind == "mrope":
        if positions is None or tuple(positions.shape) != (3, b, s):
            got = None if positions is None else tuple(positions.shape)
            raise ValueError(
                f"{cfg.arch_id} uses M-RoPE: pass positions of shape (3, {b}, {s}) "
                f"(temporal, height, width streams), got {got}"
            )
        return positions
    if positions is None:
        return torch.arange(s, device=tokens.device).expand(b, s)
    return positions


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _is_moe_block(cfg: ModelConfig, kind: str) -> bool:
    return cfg.is_moe and kind in ("attn", "swa")


def block_spec(cfg: ModelConfig, kind: str) -> Dict:
    _check_kind(kind)
    d = cfg.d_model
    spec: Dict[str, Any] = {"norm1": norm_spec(d, cfg.norm)}
    if kind in ("attn", "swa"):
        spec["mixer"] = attention_spec(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.attn_bias
        )
    elif kind == "rglru":
        spec["mixer"] = griffin_block_spec(d, cfg.d_rnn or d)
    else:  # rwkv
        spec["mixer"] = rwkv6_timemix_spec(d, cfg.n_heads)
    spec["norm2"] = norm_spec(d, cfg.norm)
    if kind == "rwkv":
        spec["ffn"] = rwkv6_channelmix_spec(d, cfg.d_ff)
    elif _is_moe_block(cfg, kind):
        spec["ffn"] = moe_spec(d, cfg.d_ff, cfg.n_experts, cfg.activation, cfg.shared_expert)
    else:
        spec["ffn"] = mlp_spec(d, cfg.d_ff, cfg.activation)
    return spec


def unstack(tree: Any, n: int) -> List[Any]:
    """The ``n`` per-layer views of a stacked tree (each leaf's leading
    axis), from one ``unbind`` per leaf."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unstack(v, n) for v in tree]
        return [[p[i] for p in parts] for i in range(n)]
    return list(tree.unbind(0))


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
    positions: torch.Tensor,  # (B, S), or (3, B, S) under mrope
    collect: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[Dict]]:
    """Returns (x_out, MoE aux loss or None, cache_contrib or None)."""
    h = apply_norm(x, p["norm1"], cfg.norm)
    contrib = None
    if kind in ("attn", "swa"):
        window = cfg.sliding_window if kind == "swa" else None
        y = mha(
            p["mixer"], h, positions, causal=True, window=window,
            rope_theta=cfg.rope_theta, rope_kind=cfg.rope_kind, impl=cfg.impl,
        )
        if collect:
            k, v = project_kv(p["mixer"], h, positions, cfg.rope_theta, cfg.rope_kind)
            contrib = {"k": k, "v": v}
    elif kind == "rglru":
        y, contrib = griffin_block(p["mixer"], h, impl=cfg.impl)
    else:  # rwkv
        y, contrib = rwkv6_timemix(p["mixer"], h, cfg.n_heads, impl=cfg.impl)
    # On a mesh DTensor lays out each op's result by itself; pinning the
    # residual stream here too (the reference pins it only at the block's
    # end) keeps a pending sum from turning into a sequence shard.
    x = constrain(x + y, ("batch", "seq", "embed"))
    h2 = apply_norm(x, p["norm2"], cfg.norm)
    aux = None
    if kind == "rwkv":
        f, chan_state = rwkv6_channelmix(p["ffn"], h2)
        contrib = dict(contrib, channel=chan_state)
    elif _is_moe_block(cfg, kind) and cfg.moe_dense:
        f = apply_moe_dense_reference(p["ffn"], h2, top_k=cfg.top_k, activation=cfg.activation)
    elif _is_moe_block(cfg, kind):
        f, aux = apply_moe(p["ffn"], h2, top_k=cfg.top_k, activation=cfg.activation,
                           capacity_factor=cfg.moe_capacity_factor)
    else:
        f = apply_mlp(h2, p["ffn"], cfg.activation)
    x = constrain(x + f, ("batch", "seq", "embed"))
    return x, aux, contrib if collect else None


def _apply_block_decode(
    cfg: ModelConfig,
    kind: str,
    p: Dict,
    x: torch.Tensor,  # (B, 1, D)
    cursor: torch.Tensor,  # (B,) int32 absolute position of this token
    cache: Dict,
    active: Optional[torch.Tensor],  # (B,) live-slot bitmap (arena)
    attn_views: Optional[Tuple[torch.Tensor, torch.Tensor]],  # (kv_pos, kv_valid)
    mrope_position: Optional[torch.Tensor] = None,  # (3, B, 1) under mrope
) -> torch.Tensor:
    """One token through one block; updates ``cache`` in place: this
    token's K/V for attention kinds, every state leaf for the recurrent
    ones. As in the reference, recurrent states advance on every row
    whatever ``active`` says (only attention reads the bitmap)."""
    h = apply_norm(x, p["norm1"], cfg.norm)
    if kind in ("attn", "swa"):
        pos_for_kv = mrope_position if cfg.rope_kind == "mrope" else cursor[:, None]
        k, v = project_kv(p["mixer"], h, pos_for_kv, cfg.rope_theta, cfg.rope_kind)
        if kind == "attn":
            kvcache.attn_cache_write(cache, k, v, cursor)
            kv_pos, valid = attn_views
            window = None
        else:
            kvcache.ring_cache_write(cache, k, v, cursor)
            _, _, kv_pos, valid = kvcache.ring_cache_views(cache, cursor)
            window = cfg.sliding_window
        y = mha_decode(
            p["mixer"], h, cursor, cache["k"], cache["v"], kv_pos, valid,
            window=window, rope_theta=cfg.rope_theta, rope_kind=cfg.rope_kind,
            mrope_position=mrope_position, impl=cfg.impl, active=active,
        )
    elif kind == "rglru":
        y, state = griffin_block(
            p["mixer"], h, state={"h": cache["h"], "conv": cache["conv"]}, impl=cfg.impl
        )
        cache["h"].copy_(state["h"])
        cache["conv"].copy_(state["conv"])
    else:  # rwkv
        y, state = rwkv6_timemix(
            p["mixer"], h, cfg.n_heads,
            state={"shift": cache["shift"], "wkv": cache["wkv"]},
            impl=cfg.impl, wkv_out=cache["wkv"],
        )
        cache["shift"].copy_(state["shift"])
    x = x + y
    h2 = apply_norm(x, p["norm2"], cfg.norm)
    if kind == "rwkv":
        f, chan = rwkv6_channelmix(p["ffn"], h2, state=cache["channel"])
        cache["channel"].copy_(chan)
    elif _is_moe_block(cfg, kind):
        # Decode: a tiny token count; the reference widens capacity to
        # avoid drops (and ignores ``moe_dense``) here.
        f, _ = apply_moe(p["ffn"], h2, top_k=cfg.top_k, activation=cfg.activation,
                         capacity_factor=2.0)
    else:
        f = apply_mlp(h2, p["ffn"], cfg.activation)
    return x + f


def _fill_from_prefill(kind: str, cache: Dict, contrib: Dict, positions) -> None:
    """Write one layer's prefill contribution into its cache, in place."""
    if kind == "attn":
        s = contrib["k"].shape[1]
        cache["k"][:, :s] = contrib["k"].to(cache["k"].dtype)
        cache["v"][:, :s] = contrib["v"].to(cache["v"].dtype)
    elif kind == "swa":
        kvcache.ring_cache_fill_from_prefill(cache, contrib["k"], contrib["v"], positions)
    else:
        for name, val in contrib.items():
            cache[name].copy_(val)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def _layer_cache(
    cfg: ModelConfig, kind: str, batch: int, max_len: int, device, lead: Tuple[int, ...] = ()
) -> Dict[str, torch.Tensor]:
    """One layer's cache (``lead`` = (n_super,) for a stacked entry)."""
    _check_kind(kind)
    hd = cfg.resolved_head_dim
    if kind == "attn":
        return kvcache.attn_cache_init(
            batch, max_len, cfg.n_kv_heads, hd, cfg.dtype, device, lead
        )
    if kind == "swa":
        return kvcache.ring_cache_init(
            batch, min(cfg.sliding_window, max_len), cfg.n_kv_heads, hd, cfg.dtype,
            device, lead,
        )
    if kind == "rglru":
        return griffin_init_state(batch, cfg.d_rnn or cfg.d_model, device, lead)
    return rwkv6_init_state(batch, cfg.d_model, cfg.n_heads, device, lead)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    cache: Dict[str, Any] = {}
    if cfg.n_super > 0:
        cache["super"] = [
            _layer_cache(cfg, kind, batch, max_len, device, lead=(cfg.n_super,))
            for kind in cfg.block_pattern
        ]
    cache["tail"] = [
        _layer_cache(cfg, kind, batch, max_len, device) for kind in cfg.tail_kinds
    ]
    return cache


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


class Transformer:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._spec = model_spec(cfg)
        # Per-layer parameter views of the last params tree seen without
        # a gradient: the decode loop slices the stacked tensors once, not
        # every step. Never kept while autograd records (views of an
        # earlier graph, or of parameters an optimizer replaced).
        self._param_views: Optional[Tuple[Any, List]] = None

    # ----- params -----------------------------------------------------
    def spec(self):
        return self._spec

    def init(self, generator: torch.Generator, dtype=None, device="cuda"):
        """Random parameters drawn from ``generator`` (on ``device``)."""
        return build_params(self._spec, generator, dtype or self.cfg.dtype, device)

    def abstract_params(self, dtype=None):
        """The parameters' shapes and dtypes on the ``meta`` device."""
        return abstract_params(self._spec, dtype or self.cfg.dtype)

    def axes(self):
        """The parameters' logical axes, a tree of tuples."""
        return build_axes(self._spec)

    def _layers(self, params) -> List[Tuple[str, Dict, Tuple]]:
        """[(kind, layer params, where)] in depth order: superblock i at
        pattern position j (``where = ("super", j, i)``), then tail layer t
        (``("tail", t, None)``). Cut anew whenever a gradient is
        recorded."""
        grad = torch.is_grad_enabled()
        if not grad and self._param_views is not None and self._param_views[0] is params:
            return self._param_views[1]
        cfg = self.cfg
        out = []
        per_kind = [unstack(params["super"][j], cfg.n_super)
                    for j in range(len(cfg.block_pattern))] if cfg.n_super > 0 else []
        for i in range(cfg.n_super):
            for j, kind in enumerate(cfg.block_pattern):
                out.append((kind, per_kind[j][i], ("super", j, i)))
        for t, (p_layer, kind) in enumerate(zip(params["tail"], cfg.tail_kinds)):
            out.append((kind, p_layer, ("tail", t, None)))
        self._param_views = None if grad else (params, out)
        return out

    @staticmethod
    def _cache_view(cache, where) -> Dict[str, torch.Tensor]:
        """One layer's cache leaves: contiguous views into the stacked
        cache, written in place."""
        part, j, i = where
        if part == "tail":
            return cache["tail"][j]
        return {name: t[i] for name, t in cache["super"][j].items()}

    def _embed(self, params, tokens):
        x = embed_lookup(params["embed"], tokens)
        if self.cfg.embed_scale:
            x = x * math.sqrt(self.cfg.d_model)
        return constrain(x, ("batch", "seq", "embed"))

    def _logits(self, params, x):
        x = apply_norm(x, params["final_norm"], self.cfg.norm)
        if self.cfg.tie_embeddings:
            return unembed(x, params["embed"])
        return x.float() @ params["lm_head"].float()

    # ----- forward ------------------------------------------------------
    def forward(
        self, params, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) integer; positions: (B, S), or (3, B, S) under
        mrope (required there). Returns (logits f32, aux): aux sums the MoE
        layers' load-balancing losses (0 without experts)."""
        x, aux = self._trunk(params, tokens, positions)
        return self._logits(params, x), aux

    def last_logits(
        self, params, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """``forward``'s logits at the last position alone, (B, V) f32: the
        head runs on one position, so no (B, S, V) tensor is made (the
        serving engine's prefill, whose CUDA graph would keep it)."""
        x, _ = self._trunk(params, tokens, positions)
        return self._logits(params, x[:, -1:])[:, 0]

    def _trunk(self, params, tokens, positions) -> Tuple[torch.Tensor, torch.Tensor]:
        """The embedding and every block: (final hidden states (B, S, D),
        the MoE aux sum)."""
        positions = _positions(self.cfg, tokens, positions)
        x = self._embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for kind, p, _ in self._layers(params):
            if remat:
                x, a, _ = checkpoint(_apply_block_full, self.cfg, kind, p, x, positions,
                                     False, use_reentrant=False,
                                     context_fn=remat_contexts)
            else:
                x, a, _ = _apply_block_full(self.cfg, kind, p, x, positions, collect=False)
            if a is not None:
                aux = aux + a
        return x, aux

    def loss(self, params, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
             aux_weight: float = 0.01) -> torch.Tensor:
        """Mean next-token negative log-likelihood of ``forward``'s logits,
        plus ``aux_weight`` times the MoE load-balancing loss: the
        reference's formula."""
        logits, aux = self.forward(params, tokens, positions)
        logp = F.log_softmax(logits[:, :-1], dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
        return nll.mean() + aux_weight * aux

    # ----- decode ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return init_cache(self.cfg, batch, max_len, device)

    def decode_step(
        self,
        params,
        cache,
        token: torch.Tensor,  # (B,) integer
        cursor: torch.Tensor,  # (B,) int32 absolute position of this token
        mrope_position: Optional[torch.Tensor] = None,  # (3, B, 1)
        active: Optional[torch.Tensor] = None,  # (B,) bool live-slot bitmap
    ) -> Tuple[torch.Tensor, Any]:
        """One-token decode: returns (logits (B, V) f32, cache). The cache
        is updated IN PLACE (the returned tree is the one passed in).

        ``active`` marks live slot-arena rows: dead rows are masked out of
        attention (the kernel skips all their KV tiles) and their logits
        are unspecified — the engine never reads them. ``None`` means
        every row is live. Recurrent states advance on every row.

        Under mrope, ``mrope_position`` rotates this token's q and k; it
        defaults to the cursor on all three streams, as in the reference.
        """
        if self.cfg.rope_kind == "mrope" and mrope_position is None:
            mrope_position = cursor[None, :, None].expand(3, cursor.shape[0], 1)
        x = self._embed(params, token[:, None])
        views = None  # full-cache positions and validity, shared by attn layers
        for kind, p, where in self._layers(params):
            layer_cache = self._cache_view(cache, where)
            if kind == "attn" and views is None:
                _, _, kv_pos, valid = kvcache.attn_cache_views(layer_cache, cursor)
                views = (kv_pos, valid)
            x = _apply_block_decode(
                self.cfg, kind, p, x, cursor, layer_cache, active, views, mrope_position
            )
        return self._logits(params, x)[:, 0], cache

    # ----- prefill (forward + cache population) ----------------------------
    def prefill(
        self, params, cache, tokens: torch.Tensor, positions=None
    ) -> Tuple[torch.Tensor, Any]:
        """Left-aligned prefill: fills caches for slots [0, S) in place and
        returns (last-token logits (B, V), cache). Positions as in
        ``forward``; K is cached rotated by them."""
        positions = _positions(self.cfg, tokens, positions)
        pos1d = positions if positions.dim() == 2 else positions[0]
        x = self._embed(params, tokens)
        for kind, p, where in self._layers(params):
            x, _, contrib = _apply_block_full(self.cfg, kind, p, x, positions, True)
            _fill_from_prefill(kind, self._cache_view(cache, where), contrib, pos1d)
        return self._logits(params, x[:, -1:])[:, 0], cache
