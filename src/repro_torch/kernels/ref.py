"""Plain PyTorch versions of the attention kernels.

They re-derive the math with a materialized softmax, independent of the
kernels: the CPU tests hold them against the JAX package, ``ops`` runs
them for CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. All arithmetic is float32; outputs take the
query's dtype.

One departure from ``repro.kernels.ref``: a decode row with NO live slot
(``active`` off, or every slot masked) outputs exact 0, which is what
the kernels compute. The JAX oracle zeros only ``active=False`` rows.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Materialized-softmax attention with arange positions."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (B, 1, H, D)
    cache_k: torch.Tensor,  # (B, S, KV, D)
    cache_v: torch.Tensor,
    cursor: torch.Tensor,  # (B,) current absolute position
    kv_pos: torch.Tensor,  # (B, S)
    kv_valid: torch.Tensor,  # (B, S) bool
    active: Optional[torch.Tensor] = None,  # (B,) bool
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    b, _, h, d = q.shape
    kv = cache_k.shape[2]
    g = h // kv
    qg = q.reshape(b, 1, kv, g, d).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k.float()) / math.sqrt(d)
    cursor = cursor.long()
    kv_pos = kv_pos.long()
    mask = (kv_pos <= cursor[:, None]) & kv_valid.bool()
    if window is not None:
        mask &= kv_pos > (cursor[:, None] - window)
    if active is not None:
        mask &= active.bool()[:, None]
    logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache_v.float())
    out = out.reshape(b, 1, h, d)
    # A row that attends to nothing outputs exact 0 (the kernels skip
    # every tile of it), not the uniform mean of V.
    live = mask.any(dim=-1)
    out = torch.where(live[:, None, None, None], out, 0.0)
    return out.to(q.dtype)
