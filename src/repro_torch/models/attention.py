"""Attention: GQA/MQA, causal, sliding-window, decode against a cache.

Two execution paths, selected by ``impl``:

- ``"xla"`` (the default) and ``"pallas"`` route through
  ``repro_torch.kernels.ops``: the hand-written Hopper kernels for CUDA
  tensors (flash attention for prefill, decode attention for one token),
  their plain PyTorch versions for CPU tensors.
- ``"dense"`` is the explicit plain path on any device:
  materialized-logits attention under a mask from ``build_mask``.

Public layouts are the JAX package's: ``wq (D, H, K)``, q ``(B, S, H, D)``,
caches ``(B, S, KV, D)``, M-RoPE positions ``(3, B, S)``.

Masks follow the reference's default (``xla``) semantics on every path:

- M-RoPE (qwen2-vl) masks prefill by the temporal stream's position
  values (``positions[0]``), so an image's tokens, which share one
  temporal position, attend to each other both ways; the kernel path
  passes those positions to the flash kernel.
- Cross-attention (``kv_override``, whisper) has no causal mask and no
  rope on K; its keys sit at ``arange(S_kv)``.
- ``mha_decode(causal=False)`` drops ``kv_pos <= cursor`` on every path.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import Param, apply_mrope, apply_rope
from repro_torch.models.sharding_hooks import flattenable, reshape

NEG_INF = -1e30

KERNEL_IMPLS = ("xla", "pallas")
ROPE_KINDS = ("rope", "mrope", "none")


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
    if rope_kind not in ROPE_KINDS:
        raise ValueError(f"unknown rope_kind {rope_kind!r}")


def _rotate(t: torch.Tensor, positions, rope_theta, rope_kind: str) -> torch.Tensor:
    """``t`` rotated by its positions: (B, S) for rope, (3, B, S) for
    mrope; unchanged for "none" (or rope without a theta)."""
    if rope_kind == "rope" and rope_theta is not None:
        return apply_rope(t, positions, rope_theta)
    if rope_kind == "mrope":
        return apply_mrope(t, positions, rope_theta)
    return t


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
        mask = mask & (k <= q)
    if window is not None:
        mask = mask & (k > q - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    return mask


def dense_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KV, D)
    v: torch.Tensor,  # (B, Skv, KV, D)
    mask: torch.Tensor,  # (B, Sq, Skv) bool
) -> torch.Tensor:
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = reshape(q, b, sq, kv, h // kv, d).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(d)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return reshape(out, b, sq, h, d).to(q.dtype)


def _dense(q, k, v, mask) -> torch.Tensor:
    """``dense_attention``; on a mesh, on each rank's shard of whole batch
    rows and head groups, as the kernels run (``ops.mesh_call``)."""
    if any(kernel_ops.is_dtensor(t) for t in (q, k, v)):
        bh = {"batch": 0, "heads": 2}
        return kernel_ops.mesh_call(dense_attention, [q, k, v, mask],
                                    [bh, bh, bh, {"batch": 0}], [bh])
    return dense_attention(q, k, v, mask)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk' as one matrix product."""
    d, h, k = w.shape
    return reshape(x @ reshape(flattenable(w, 1, 2), d, h * k), *x.shape[:-1], h, k)


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
    o = reshape(flattenable(o, o.dim() - 2, o.dim() - 1), *o.shape[:-2], h * k)
    y = o @ reshape(flattenable(p["wo"], 0, 1), h * k, d)
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
    return _rotate(k, positions, rope_theta, rope_kind), v


# ---------------------------------------------------------------------------
# Full multi-head attention layer
# ---------------------------------------------------------------------------


def mha(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S), or (3, B, S) for mrope
    *,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: Optional[float] = 10000.0,
    rope_kind: str = "rope",  # rope | mrope | none
    impl: str = "xla",  # xla | pallas | dense
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attn
    q_scale: Optional[float] = None,  # q's factor after rotation (Granite's multiplier)
) -> torch.Tensor:
    """Self- (or cross-) attention over a full sequence (prefill).

    Self-attention with rope or none: the kernel path assumes arange
    positions, as the reference's flash kernel does. Under mrope it masks
    by ``positions[0]``; with ``kv_override = (k, v)`` (B, S_kv, KV, D)
    there is no causal mask and no rope on K, and keys sit at
    ``arange(S_kv)``."""
    _check_impl(impl)
    _check_rope(rope_kind)
    pos1d = positions if positions.dim() == 2 else positions[0]
    rot = pos1d if rope_kind == "rope" else positions
    if kv_override is None:
        q, k, v = project_qkv(p, x)
        k = _rotate(k, rot, rope_theta, rope_kind)
        kv_pos = pos1d
    else:
        q = _proj(x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        k, v = kv_override
        causal = False
        kv_pos = torch.arange(k.shape[1], device=x.device).expand(x.shape[0], k.shape[1])
    q = _rotate(q, rot, rope_theta, rope_kind)
    if q_scale is not None:
        q = q * q_scale
    if impl in KERNEL_IMPLS:
        mask_pos = {}
        if kv_override is not None or rope_kind == "mrope":
            mask_pos = dict(q_pos=pos1d.to(torch.int32).contiguous(),
                            kv_pos=kv_pos.to(torch.int32).contiguous())
        o = kernel_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            causal=causal, window=window, **mask_pos,
        )
    else:
        mask = build_mask(pos1d, kv_pos, None, causal, window)
        o = _dense(q, k, v, mask)
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
    causal: bool = True,  # False for cross-attention
    window: Optional[int] = None,
    rope_theta: Optional[float] = 10000.0,
    rope_kind: str = "rope",
    mrope_position: Optional[torch.Tensor] = None,  # (3, B, 1)
    impl: str = "xla",
    active: Optional[torch.Tensor] = None,  # (B,) live-slot bitmap (arena)
    q_scale: Optional[float] = None,  # as in ``mha``
) -> torch.Tensor:
    """One-token attention against a KV cache. The caller has already
    written this token's K/V into the cache; q is projected and rotated
    here (by ``mrope_position`` under mrope). ``causal=False`` drops the
    ``kv_pos <= position`` term. ``active`` marks live slot-arena rows: a
    dead row attends to nothing (the kernel skips all its KV tiles and
    outputs 0; the dense path's output for it is unspecified), so batch
    size is data."""
    _check_impl(impl)
    _check_rope(rope_kind)
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = _rotate(q, mrope_position if rope_kind == "mrope" else position[:, None],
                rope_theta, rope_kind)
    if q_scale is not None:
        q = q * q_scale
    if impl in KERNEL_IMPLS:
        o = kernel_ops.decode_attention(
            q.contiguous(), cache_k, cache_v, position, kv_positions, kv_valid,
            active, window=window, causal=causal,
        )
    else:
        if active is not None:
            kv_valid = kv_valid & active[:, None]
        mask = build_mask(position[:, None], kv_positions, kv_valid, causal, window)
        o = _dense(q, cache_k, cache_v, mask)
    return project_out(p, o)
