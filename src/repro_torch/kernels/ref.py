"""Plain PyTorch versions of the kernels.

They re-derive the math independently of the kernels (a materialized
softmax for attention, a step-by-step loop over time for the two
recurrences): the CPU tests hold them against the JAX package, ``ops``
runs them for CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. All arithmetic is float32; outputs take the
dtype of the first input (the query, ``r`` or ``a``), carried states are
float32.

One departure from ``repro.kernels.ref``: a decode row with NO live slot
(``active`` off, or every slot masked) outputs exact 0, which is what
the kernels compute. The JAX oracle zeros only ``active=False`` rows.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def rglru_ref(
    a: torch.Tensor,  # (B, S, D) decay in (0, 1)
    b_in: torch.Tensor,  # (B, S, D) gated inputs
    h0: Optional[torch.Tensor] = None,  # (B, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential linear recurrence h_t = a_t h_{t-1} + b_t. Returns
    (h for every step in a's dtype, last h in float32)."""
    bsz, s, d = a.shape
    if h0 is None:
        h = torch.zeros((bsz, d), dtype=torch.float32, device=a.device)
    else:
        h = h0.float()
    af, bf = a.float(), b_in.float()
    hs = []
    for t in range(s):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype), h


def wkv6_ref(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K) decay in (0, 1)
    u: torch.Tensor,  # (H, K) bonus
    state: Optional[torch.Tensor] = None,  # (B, H, K, V)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 recurrence, one step at a time:
    o_t = r_t (S + diag(u) k_t^T v_t), S <- diag(w_t) S + k_t^T v_t.
    Returns (o in r's dtype, last state in float32)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if state is None:
        st = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    else:
        st = state.float()
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w.float()
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uf * kv))
        st = wf[:, t, :, :, None] * st + kv
    return torch.stack(outs, dim=1).to(r.dtype), st
