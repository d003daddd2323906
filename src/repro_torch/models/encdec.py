"""Whisper-style encoder-decoder backbone, in PyTorch (conv frontend a stub).

As in ``repro.models.encdec``, the modality frontend is a stub: callers
pass precomputed frame embeddings (B, T_enc, d_model); the two strided
convolutions of real Whisper are out of scope. Everything after that is
the architecture: sinusoidal positions and a bidirectional encoder;
learned positions, causal self-attention and cross-attention in the
decoder; LayerNorm, GELU and attention biases.

Parameters are stacked along a leading layer axis (``encoder`` and
``decoder``), exactly as the reference lays them out, so converted JAX
parameters load as they are. Where the reference scans over that axis,
this module loops over it.

Decode caches: per decoder layer a full self-attention KV cache plus the
cross-attention K/V, computed once from the encoder output
(``encode_for_decode``) and read-only afterwards. Every cache write is in
place. ``decode_step`` masks dead rows (``active``) out of both
attentions. On the kernel path the encoder's, the decoder's and the
cross-attention's full-sequence passes run the flash kernel (the cross
one at ``S_kv = T_enc``), and both decode attentions the decode kernel
(the cross one with ``causal=False``).

Training: with ``cfg.remat`` set and autograd recording, each encoder and
decoder layer runs under ``torch.utils.checkpoint`` (non-reentrant), as
the reference wraps its scanned blocks in ``jax.checkpoint``; per-layer
views come from one ``unbind`` per stacked leaf and are cached only while
no gradient is recorded.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models.attention import (
    _proj,
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
    sinusoidal_positions,
    unembed,
)
from repro_torch.models.sharding_hooks import constrain, remat_contexts, replicate
from repro_torch.models.transformer import unstack

BSE = ("batch", "seq", "embed")


def _attn_spec(cfg: ModelConfig) -> Dict[str, Param]:
    return attention_spec(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, bias=True
    )


def _enc_block_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "norm1": norm_spec(d, cfg.norm),
        "attn": _attn_spec(cfg),
        "norm2": norm_spec(d, cfg.norm),
        "ffn": mlp_spec(d, cfg.d_ff, cfg.activation),
    }


def _dec_block_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "norm1": norm_spec(d, cfg.norm),
        "self_attn": _attn_spec(cfg),
        "norm_cross": norm_spec(d, cfg.norm),
        "cross_attn": _attn_spec(cfg),
        "norm2": norm_spec(d, cfg.norm),
        "ffn": mlp_spec(d, cfg.d_ff, cfg.activation),
    }


def _stack(spec: Any, n: int) -> Any:
    return map_tree(
        lambda p: Param((n,) + p.shape, ("layer",) + p.axes, p.init, p.scale), spec
    )


def model_spec(cfg: ModelConfig) -> Dict:
    return {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model),
        "dec_pos": Param((cfg.max_dec_positions, cfg.d_model), (None, "embed"), scale=0.02),
        "encoder": _stack(_enc_block_spec(cfg), cfg.n_encoder_layers),
        "enc_final_norm": norm_spec(cfg.d_model, cfg.norm),
        "decoder": _stack(_dec_block_spec(cfg), cfg.n_layers),
        "dec_final_norm": norm_spec(cfg.d_model, cfg.norm),
    }


def _cross_kv(p: Dict[str, torch.Tensor], enc_out: torch.Tensor):
    """Cross-attention K/V of one decoder layer from the encoder output."""
    k = _proj(enc_out, p["wk"])
    v = _proj(enc_out, p["wv"])
    if "bv" in p:
        v = v + p["bv"]
    return k, v


class EncDecTransformer:
    """Whisper-family model. ``cfg.n_layers`` = decoder layers,
    ``cfg.n_encoder_layers`` = encoder layers."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.MAX_DEC_POSITIONS = cfg.max_dec_positions
        self._spec = model_spec(cfg)
        # Per-layer parameter views of the last params tree seen without a
        # gradient (never kept while autograd records).
        self._param_views: Optional[Tuple[Any, Dict[str, List[Dict]]]] = None

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

    def _layers(self, params, part: str) -> List[Dict]:
        """Layer ``i``'s parameters of ``part`` ("encoder" or "decoder"),
        sliced once per params tree, or anew whenever a gradient is
        recorded."""
        grad = torch.is_grad_enabled()
        if grad or self._param_views is None or self._param_views[0] is not params:
            views = {
                name: unstack(params[name], n)
                for name, n in (("encoder", self.cfg.n_encoder_layers),
                                ("decoder", self.cfg.n_layers))
            }
            self._param_views = None if grad else (params, views)
            return views[part]
        return self._param_views[1][part]

    def _remat(self) -> bool:
        return self.cfg.remat and torch.is_grad_enabled()

    def _enc_block(self, p, x, positions):
        cfg = self.cfg
        h = apply_norm(x, p["norm1"], cfg.norm, cfg.impl)
        x = constrain(x + mha(p["attn"], h, positions, causal=False, rope_theta=None,
                              rope_kind="none", impl=cfg.impl), BSE)
        h2 = apply_norm(x, p["norm2"], cfg.norm, cfg.impl)
        return constrain(x + apply_mlp(h2, p["ffn"], cfg.activation), BSE)

    # ----- encoder --------------------------------------------------------
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, d_model) precomputed embeddings (frontend stub)."""
        cfg = self.cfg
        b, t, d = frames.shape
        x = frames + sinusoidal_positions(t, d, frames.device).to(frames.dtype)[None]
        x = constrain(x, BSE)
        positions = torch.arange(t, device=frames.device).expand(b, t)
        remat = self._remat()
        for p in self._layers(params, "encoder"):
            if remat:
                x = checkpoint(self._enc_block, p, x, positions, use_reentrant=False,
                               context_fn=remat_contexts)
            else:
                x = self._enc_block(p, x, positions)
        return apply_norm(x, params["enc_final_norm"], cfg.norm, cfg.impl)

    # ----- decoder, full sequence (training) ------------------------------
    def _dec_block_full(self, p, x, positions, enc_out):
        cfg = self.cfg
        h = apply_norm(x, p["norm1"], cfg.norm, cfg.impl)
        x = constrain(x + mha(p["self_attn"], h, positions, causal=True, rope_theta=None,
                              rope_kind="none", impl=cfg.impl), BSE)
        hc = apply_norm(x, p["norm_cross"], cfg.norm, cfg.impl)
        x = x + mha(p["cross_attn"], hc, positions, causal=False, rope_theta=None,
                    rope_kind="none", impl=cfg.impl,
                    kv_override=_cross_kv(p["cross_attn"], enc_out))
        x = constrain(x, BSE)
        h2 = apply_norm(x, p["norm2"], cfg.norm, cfg.impl)
        return constrain(x + apply_mlp(h2, p["ffn"], cfg.activation), BSE)

    def _embed_dec(self, params, tokens, positions):
        x = embed_lookup(params["embed"], tokens)
        return x + params["dec_pos"][replicate(positions)].to(x.dtype)

    def forward(
        self, params, frames: torch.Tensor, dec_tokens: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward: returns (decoder logits f32, aux = 0)."""
        enc_out = self.encode(params, frames)
        b, s = dec_tokens.shape
        positions = torch.arange(s, device=dec_tokens.device).expand(b, s)
        x = self._embed_dec(params, dec_tokens, positions)
        remat = self._remat()
        for p in self._layers(params, "decoder"):
            if remat:
                x = checkpoint(self._dec_block_full, p, x, positions, enc_out,
                               use_reentrant=False, context_fn=remat_contexts)
            else:
                x = self._dec_block_full(p, x, positions, enc_out)
        x = apply_norm(x, params["dec_final_norm"], self.cfg.norm, self.cfg.impl)
        return unembed(x, params["embed"]), torch.zeros((), dtype=torch.float32,
                                                        device=x.device)

    def loss(self, params, frames, dec_tokens, aux_weight: float = 0.0):
        """Mean next-token cross entropy of the teacher-forced forward."""
        logits, _ = self.forward(params, frames, dec_tokens)
        logp = F.log_softmax(logits[:, :-1], dim=-1)
        nll = -torch.gather(logp, -1, dec_tokens[:, 1:, None].long())[..., 0]
        return nll.mean()

    # ----- decode ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, enc_len: int, device="cuda"):
        cfg = self.cfg
        shape = (cfg.n_layers, batch)
        tail = (cfg.n_kv_heads, cfg.resolved_head_dim)

        def zeros(length):
            return torch.zeros(shape + (length,) + tail, dtype=cfg.dtype, device=device)

        return {"self_k": zeros(max_len), "self_v": zeros(max_len),
                "cross_k": zeros(enc_len), "cross_v": zeros(enc_len)}

    def encode_for_decode(self, params, frames, cache):
        """Run the encoder and write every decoder layer's cross K/V into
        ``cache``, in place; returns ``cache``."""
        enc_out = self.encode(params, frames)
        for i, p in enumerate(self._layers(params, "decoder")):
            k, v = _cross_kv(p["cross_attn"], enc_out)
            cache["cross_k"][i].copy_(k)
            cache["cross_v"][i].copy_(v)
        return cache

    def decode_step(
        self, params, cache, token: torch.Tensor, cursor: torch.Tensor,
        active: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Any]:
        """One decoder token against the self and cross caches: returns
        (logits (B, V) f32, cache), the self cache updated in place.
        token: (B,), cursor: (B,) int32; ``active``: (B,) live-slot bitmap;
        dead rows are masked out of both attentions (their logits are
        unspecified)."""
        cfg = self.cfg
        b = token.shape[0]
        x = self._embed_dec(params, token[:, None], cursor.long()[:, None])
        enc_len = cache["cross_k"].shape[2]
        enc_pos = torch.arange(enc_len, dtype=torch.int32, device=token.device).expand(
            b, enc_len).contiguous()
        enc_valid = torch.ones((b, enc_len), dtype=torch.bool, device=token.device)
        if active is not None:
            enc_valid = enc_valid & active[:, None]
        views = None  # self-cache positions and validity, shared by every layer
        for i, p in enumerate(self._layers(params, "decoder")):
            layer = {"k": cache["self_k"][i], "v": cache["self_v"][i]}
            h = apply_norm(x, p["norm1"], cfg.norm, cfg.impl)
            k, v = project_kv(p["self_attn"], h, cursor[:, None], None, "none")
            kvcache.attn_cache_write(layer, k, v, cursor)
            if views is None:
                views = kvcache.attn_cache_views(layer, cursor)[2:]
            x = x + mha_decode(p["self_attn"], h, cursor, layer["k"], layer["v"], *views,
                               rope_theta=None, rope_kind="none", impl=cfg.impl,
                               active=active)
            hc = apply_norm(x, p["norm_cross"], cfg.norm, cfg.impl)
            x = x + mha_decode(p["cross_attn"], hc, cursor, cache["cross_k"][i],
                               cache["cross_v"][i], enc_pos, enc_valid, causal=False,
                               rope_theta=None, rope_kind="none", impl=cfg.impl,
                               active=active)
            h2 = apply_norm(x, p["norm2"], cfg.norm, cfg.impl)
            x = x + apply_mlp(h2, p["ffn"], cfg.activation)
        x = apply_norm(x, params["dec_final_norm"], cfg.norm, cfg.impl)
        return unembed(x, params["embed"])[:, 0], cache
