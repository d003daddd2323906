"""Plain PyTorch versions of the kernels.

They re-derive the math independently of the kernels (a materialized
softmax for attention, a step-by-step loop over time for the two
recurrences): the CPU tests hold them against the JAX package, ``ops``
runs them for CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. All arithmetic is float32; outputs take the
dtype of the first input (the query, ``r`` or ``a``), carried states are
float32.

``decode_attention_split_plain`` is the plain twin of the decode
kernel's two passes (per-split partials, then their combine in split
order); ``wkv6_chunked_plain`` is the plain twin of the chunked wkv6
kernel's arithmetic.

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


def decode_attention_split_plain(
    q: torch.Tensor,  # (B, 1, H, D)
    cache_k: torch.Tensor,  # (B, S, KV, D)
    cache_v: torch.Tensor,
    cursor: torch.Tensor,  # (B,)
    kv_pos: torch.Tensor,  # (B, S)
    kv_valid: torch.Tensor,  # (B, S) bool
    active: Optional[torch.Tensor] = None,  # (B,) bool
    *,
    window: Optional[int] = None,
    n_split: int = 1,
) -> torch.Tensor:
    """The plain twin of the CUDA kernel's two passes. S is cut into
    ``n_split`` ranges of whole 64-slot tiles (the kernel's), ``ceil(tiles /
    n_split)`` tiles each (trailing ranges may be empty). Each range gives
    its partial (m, l, acc): max logit, sum of exp(logit - m) over its live
    slots, and P V with P rounded to the input dtype first, as the Pallas
    kernel does (exact for float32); a range with no live slot gives
    (-1e30, 0, 0). The partials are then combined in range order. A row
    with no live slot, or with ``active`` off, outputs exact 0."""
    b, _, h, d = q.shape
    s, kv = cache_k.shape[1], cache_k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float()) / math.sqrt(d)
    cursor = cursor.long()
    kv_pos = kv_pos.long()
    mask = (kv_pos <= cursor[:, None]) & kv_valid.bool()
    if window is not None:
        mask &= kv_pos > (cursor[:, None] - window)
    if active is not None:
        mask &= active.bool()[:, None]
    mask = mask[:, None, None, :]  # (B, 1, 1, S)
    vf = cache_v.float()
    tiles = -(-s // 64)
    per = -(-tiles // n_split) * 64  # slots per range
    parts = []
    for z in range(n_split):
        lo, hi = min(z * per, s), min((z + 1) * per, s)
        if lo == hi:  # an empty trailing range: no live slot
            parts.append((torch.full_like(logits[..., 0], NEG_INF),
                          torch.zeros_like(logits[..., 0]), torch.zeros_like(qg)))
            continue
        lg = torch.where(mask[..., lo:hi], logits[..., lo:hi], NEG_INF)
        m = lg.amax(dim=-1)  # (B, KV, G); NEG_INF where no slot is live
        p = torch.where(mask[..., lo:hi], torch.exp(lg - m[..., None]), 0.0)
        pv = p.to(q.dtype).float()
        acc = torch.einsum("bkgs,bskd->bkgd", pv, vf[:, lo:hi])
        parts.append((m, p.sum(dim=-1), acc))
    m_all = torch.stack([m for m, _, _ in parts])  # (n_split, B, KV, G)
    mm = m_all.amax(dim=0)
    wts = torch.exp(m_all - mm)
    ll = sum(w * l for w, (_, l, _) in zip(wts, parts))
    acc = sum(w[..., None] * a for w, (_, _, a) in zip(wts, parts))
    out = torch.where(ll[..., None] > 0, acc / torch.clamp(ll, min=1e-30)[..., None], 0.0)
    return out.reshape(b, 1, h, d).to(q.dtype)


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


WKV_LOG_CLAMP = -60.0  # log w is clamped below here: w = 0 stays finite


def wkv6_chunked_plain(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K)
    u: torch.Tensor,  # (H, K)
    state: Optional[torch.Tensor] = None,  # (B, H, K, V)
    *,
    chunk: int = 64,
    half: int = 8,
    operand_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the chunked CUDA kernel's arithmetic (``wkv6``
    on bfloat16 inputs with S >= 64). S is padded to whole chunks with
    identity steps (w = 1, r = k = v = 0). With a = max(log w, -60), L its
    running sum inside each ``half``-step block (restarted at each) and T
    a block's total:

    - each chunk's state contribution (k e^(G_end - G))^T v and decay
      e^G_end, carried chunk by chunk in float32;
    - q_t = r_t e^(L_{t-1}) (referenced at its block's start) and
      kh_s = k_s e^(T - L_s) (decayed to its block's end);
    - per query block: (q e^(T of the blocks before)) S_c; against each
      earlier key block, (q e^(T of the blocks between)) kh^T; inside the
      block, the product w_{s+1} ... w_{t-1} taken step by step, with
      r_t . (u k_t) on the diagonal.

    Every exponent is a sum of a's, <= 0, never a difference of two large
    running sums. The decayed operands, the scores and S_c go to the
    tensor cores as two parts in ``operand_dtype`` (default r's dtype),
    hi = round(x) and lo = round(x - hi), as the kernel splits them (it
    drops the lo x lo product, about 2^-16 of each term); with float32
    this is the exact chunked form. Returns (o in r's dtype, last state in
    float32)."""
    od = r.dtype if operand_dtype is None else operand_dtype

    def rnd(x):
        hi = x.to(od).float()
        return hi + (x - hi).to(od).float()

    b, s, h, dk = r.shape
    dv = v.shape[-1]
    n = -(-s // chunk)
    nh = chunk // half
    pad = n * chunk - s

    def blocks(x, fill):  # (B, S, H, D) -> (B, H, n, nh, half, D), float32
        x = x.float()
        if pad:
            x = torch.cat([x, x.new_full((b, pad) + x.shape[2:], fill)], dim=1)
        return x.reshape(b, n, nh, half, h, x.shape[-1]).permute(0, 4, 1, 2, 3, 5)

    rr, kk, vv, ww = blocks(r, 0.0), blocks(k, 0.0), blocks(v, 0.0), blocks(w, 1.0)
    uf = u.float()[None, :, None, None, :]
    a = torch.clamp(torch.log(ww), min=WKV_LOG_CLAMP)
    L = torch.cumsum(a, dim=4)
    Lx = torch.cat([torch.zeros_like(L[:, :, :, :, :1]), L[:, :, :, :, :-1]], dim=4)
    tot = L[:, :, :, :, -1]  # (B, H, n, nh, K)
    to_end = tot[:, :, :, :, None] - L  # decay from s to its block's end
    # Sums of the later (post) and earlier (base) blocks' totals.
    rev = torch.flip(torch.cumsum(torch.flip(tot, [3]), dim=3), [3])
    post = torch.cat([rev[:, :, :, 1:], torch.zeros_like(rev[:, :, :, :1])], dim=3)
    kdec = rnd(kk * torch.exp(to_end + post[:, :, :, :, None]))
    d_state = torch.einsum("bhnjsk,bhnjsv->bhnkv", kdec, vv)
    decay = torch.exp(rev[:, :, :, 0])  # (B, H, n, K)

    x = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    entering = []
    for c in range(n):
        entering.append(x)
        x = decay[:, :, c, :, None] * x + d_state[:, :, c]
    s_c = rnd(torch.stack(entering, dim=2))  # (B, H, n, K, V)

    q = rr * torch.exp(Lx)
    kh = rnd(kk * torch.exp(to_end))
    outs = []
    for i in range(nh):
        # factor[m] = e^(T_m + ... + T_{i-1}), summed from the last block.
        factor = [torch.ones_like(tot[:, :, :, 0])] * (i + 1)
        between = torch.zeros_like(tot[:, :, :, 0])
        for m in range(i - 1, -1, -1):
            between = between + tot[:, :, :, m]
            factor[m] = torch.exp(between)
        qi = lambda m: rnd(q[:, :, :, i] * factor[m][:, :, :, None])
        o = torch.einsum("bhntk,bhnkv->bhntv", qi(0), s_c)
        for j in range(i):
            sc = torch.einsum("bhntk,bhnsk->bhnts", qi(j + 1), kh[:, :, :, j])
            o = o + torch.einsum("bhnts,bhnsv->bhntv", rnd(sc), vv[:, :, :, j])
        # Inside the block: f[s] = w_{s+1} ... w_{s+d-1} for pairs (s + d, s).
        ri, ki, wi = rr[:, :, :, i], kk[:, :, :, i], ww[:, :, :, i]
        diag = torch.zeros(ri.shape[:-1] + (half,), dtype=torch.float32, device=r.device)
        diag.diagonal(dim1=-2, dim2=-1).copy_((ri * uf * ki).sum(-1))
        f = torch.ones_like(ki[:, :, :, : half - 1])
        for d in range(1, half):
            vals = (ri[:, :, :, d:] * f * ki[:, :, :, : half - d]).sum(-1)
            diag.diagonal(offset=-d, dim1=-2, dim2=-1).copy_(vals)
            f = f[:, :, :, :-1] * wi[:, :, :, d : half - 1]
        outs.append(o + torch.einsum("bhnts,bhnsv->bhntv", rnd(diag), vv[:, :, :, i]))
    o = torch.stack(outs, dim=3).reshape(b, h, n * chunk, dv)[:, :, :s]
    return o.permute(0, 2, 1, 3).to(r.dtype), x
