"""Attention: GQA/MQA, causal, sliding-window, decode against a cache.

Two execution paths, selected by ``impl``:

- ``"xla"`` (the default) and ``"pallas"`` route through
  ``repro_torch.kernels.ops``: the hand-written Hopper kernels for CUDA
  tensors (flash attention for prefill, decode attention for one token),
  their plain PyTorch versions for CPU tensors.
- ``"dense"`` is the explicit plain path on any device:
  materialized-logits attention under a mask from ``build_mask``.

Public layouts are the JAX package's: ``wq (D, H, K)``, q ``(B, S, H, D)``,
caches ``(B, S, KV, D)``. Cross-attention (``kv_override``, whisper) and
M-RoPE (qwen2-vl) are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import Param, apply_rope

NEG_INF = -1e30

KERNEL_IMPLS = ("xla", "pallas")


def attention_spec(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    bias: bool = False,
) -> Dict[str, Param]:
    spec = {
        "wq": Param((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": Param((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": Param((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": Param((n_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
    }
    if bias:
        spec["bq"] = Param((n_heads, head_dim), ("heads", "head_dim"), init="zeros")
        spec["bv"] = Param((n_kv_heads, head_dim), ("kv_heads", "head_dim"), init="zeros")
        spec["bo"] = Param((d_model,), ("embed",), init="zeros")
    return spec


def _check_impl(impl: str) -> None:
    if impl not in KERNEL_IMPLS + ("dense",):
        raise ValueError(f"unknown attention impl {impl!r}")


def _check_rope(rope_kind: str) -> None:
    if rope_kind not in ("rope", "none"):
        raise NotImplementedError(
            f"rope_kind {rope_kind!r} is not ported yet (ROADMAP.md: "
            f"encdec/mrope)"
        )


# ---------------------------------------------------------------------------
# Mask helper and the dense path
# ---------------------------------------------------------------------------


def build_mask(
    q_pos: torch.Tensor,  # (B, Sq)
    kv_pos: torch.Tensor,  # (B, Skv)
    kv_valid: Optional[torch.Tensor],  # (B, Skv) bool
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """(B, Sq, Skv) boolean mask — True = attend."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    mask = torch.ones(
        q.shape[:2] + (kv_pos.shape[1],), dtype=torch.bool, device=q_pos.device
    )
    if causal:
        mask &= k <= q
    if window is not None:
        mask &= k > q - window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    return mask


def dense_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KV, D)
    v: torch.Tensor,  # (B, Skv, KV, D)
    mask: torch.Tensor,  # (B, Sq, Skv) bool
) -> torch.Tensor:
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(d)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk' as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def project_qkv(
    p: Dict[str, torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        v = v + p["bv"]
    return q, k, v


def project_out(p: Dict[str, torch.Tensor], o: torch.Tensor) -> torch.Tensor:
    h, k, d = p["wo"].shape
    y = o.reshape(*o.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)
    if "bo" in p:
        y = y + p["bo"]
    return y


def project_kv(
    p: Dict[str, torch.Tensor], x: torch.Tensor, positions, rope_theta,
    rope_kind: str = "rope",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V for cache insertion (decode) — same rotation as prefill."""
    _check_rope(rope_kind)
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bv" in p:
        v = v + p["bv"]
    if rope_kind == "rope" and rope_theta is not None:
        k = apply_rope(k, positions, rope_theta)
    return k, v


# ---------------------------------------------------------------------------
# Full multi-head attention layer
# ---------------------------------------------------------------------------


def mha(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: Optional[float] = 10000.0,
    rope_kind: str = "rope",  # rope | none
    impl: str = "xla",  # xla | pallas | dense
    kv_override=None,
) -> torch.Tensor:
    """Self-attention over a full sequence (prefill). The kernel path
    assumes arange positions, as the reference's flash kernel does."""
    _check_impl(impl)
    _check_rope(rope_kind)
    if kv_override is not None:
        raise NotImplementedError(
            "cross-attention (kv_override) is not ported yet (ROADMAP.md: encdec)"
        )
    q, k, v = project_qkv(p, x)
    if rope_kind == "rope" and rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if impl in KERNEL_IMPLS:
        o = kernel_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), positions,
            causal=causal, window=window,
        )
    else:
        mask = build_mask(positions, positions, None, causal, window)
        o = dense_attention(q, k, v, mask)
    return project_out(p, o)


def mha_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, D)
    position: torch.Tensor,  # (B,) int32 — current absolute position
    cache_k: torch.Tensor,  # (B, S_cache, KV, D) (already includes this token)
    cache_v: torch.Tensor,
    kv_positions: torch.Tensor,  # (B, S_cache) — absolute pos per slot
    kv_valid: torch.Tensor,  # (B, S_cache) bool
    *,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: Optional[float] = 10000.0,
    rope_kind: str = "rope",
    impl: str = "xla",
    active: Optional[torch.Tensor] = None,  # (B,) live-slot bitmap (arena)
) -> torch.Tensor:
    """One-token attention against a KV cache. The caller has already
    written this token's K/V into the cache; q is projected and rotated
    here. ``active`` marks live slot-arena rows: a dead row attends to
    nothing (the kernel skips all its KV tiles and outputs 0; the dense
    path's output for it is unspecified), so batch size is data."""
    _check_impl(impl)
    _check_rope(rope_kind)
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if rope_kind == "rope" and rope_theta is not None:
        q = apply_rope(q, position[:, None], rope_theta)
    if impl in KERNEL_IMPLS:
        o = kernel_ops.decode_attention(
            q.contiguous(), cache_k, cache_v, position, kv_positions, kv_valid,
            active, window=window,
        )
    else:
        if active is not None:
            kv_valid = kv_valid & active[:, None]
        mask = build_mask(position[:, None], kv_positions, kv_valid, causal, window)
        o = dense_attention(q, cache_k, cache_v, mask)
    return project_out(p, o)
