"""Plain PyTorch versions of the kernels.

They re-derive the math independently of the kernels (a materialized
softmax for attention, a step-by-step loop over time for the two
recurrences): the CPU tests hold them against the JAX package, ``ops``
runs them for CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. All arithmetic is float32; outputs take the
dtype of the first input (the query, ``r`` or ``a``), carried states are
float32.

``flash_attention_fwd_lse_plain`` adds the log-sum-exp the flash
forward writes for its backward, and ``flash_attention_bwd_plain`` is
the backward kernel's FlashAttention-2 recurrences written out (not
autograd); ``flash_attention_bwd_tiled_plain`` is the plain twin of the
backward's wgmma routes, walking their 64 x 64 tiles in their order (the
tiles ``flash_bwd_walks`` keeps, the wide route's parts of each group's
query heads from ``flash_bwd_head_parts``). ``rglru_bwd_plain`` and
``wkv6_bwd_plain`` are the two recurrences' backward kernels written out
(reverse-time recurrences, not autograd). float64 inputs keep float64 in
the flash functions and in both recurrences forward and backward, so the
CPU tests can compare algorithms without float32 summation order.
``decode_attention_split_plain`` is the plain twin of the decode
kernel's two passes (per-split partials, then their combine in split
order); ``wkv6_chunked_plain`` is the plain twin of the chunked wkv6
kernel's arithmetic. ``rmsnorm_ref`` and ``layernorm_ref`` are the
model's norms as eager float32 chains (RMS with an optional SiLU gate,
Mamba-2's ``RMSNorm(y * silu(z))``), and ``rownorm_plain`` chooses
between them as the row-norm kernel does. ``ssd_ref`` is Mamba-2's
state-space recurrence stepped token by token, ``ssd_chunked_plain`` the
chunked arithmetic of the ``ssd_chunk`` kernel, ``ssd_chunk_plain`` its
twin (the conv and SiLU, ``ssd_conv``, then that) and ``ssd_step_plain``
the twin of the ``ssd_step`` decode kernel (conv window, state step, held
rows untouched).

One departure from ``repro.kernels.ref``: a decode row with NO live slot
(``active`` off, or every slot masked) outputs exact 0, which is what
the kernels compute. The JAX oracle zeros only ``active=False`` rows.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def check_nondecreasing(name: str, pos: torch.Tensor) -> None:
    """Raise unless ``pos`` (B, S) never decreases along S: the flash
    kernel's causal tile skip under explicit positions relies on it
    (Qwen2-VL's temporal stream, and arange, satisfy it)."""
    if pos.shape[-1] > 1 and bool((pos[:, 1:] < pos[:, :-1]).any()):
        raise ValueError(f"{name} must be non-decreasing along S under a causal mask")


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the flash functions' arithmetic type: float32, or float64
    for float64 inputs (which the CPU tests use to compare algorithms
    without float32 summation order)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _check_flash_args(s, skv, causal, window, q_pos, kv_pos) -> None:
    """The flash functions' argument checks, the positions' precondition
    under a causal mask included."""
    check_flash_masks(s, skv, causal, window, q_pos, kv_pos)
    if causal and q_pos is not None:
        check_nondecreasing("q_pos", q_pos)
        check_nondecreasing("kv_pos", kv_pos)
        if bool((kv_pos[:, 0] > q_pos[:, 0]).any()):
            raise ValueError("under a causal mask every query needs a key at or before it: "
                             "kv_pos[:, 0] <= q_pos[:, 0]")


def _flash_logits(q, k, v, causal, window, q_pos, kv_pos):
    """The flash functions' shared front: the argument checks, then the
    scaled logits (B, KV, G, S, S_kv) in ``_acc``'s type and the mask (B,
    1, 1, S, S_kv)."""
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    _check_flash_args(s, skv, causal, window, q_pos, kv_pos)
    qg = _acc(q.reshape(b, s, kv, g, d))
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, _acc(k)) / math.sqrt(d)
    if q_pos is None:
        qp = torch.arange(s, device=q.device).expand(b, s)
        kp = torch.arange(skv, device=q.device).expand(b, skv)
    else:
        qp, kp = q_pos.long(), kv_pos.long()
    qp, kp = qp[:, :, None], kp[:, None, :]
    mask = torch.ones((b, s, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return logits, mask[:, None, None]


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S_kv, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_pos: Optional[torch.Tensor] = None,  # (B, S) integer
    kv_pos: Optional[torch.Tensor] = None,  # (B, S_kv) integer
) -> torch.Tensor:
    """Materialized-softmax attention. Without positions they are arange;
    with them, the causal and window masks compare position values (so
    keys that share a query's position attend both ways). ``S_kv != S``
    is non-causal and windowless only. Under a causal mask, explicit
    positions must be non-decreasing along S with ``kv_pos[:, 0] <=
    q_pos[:, 0]``, the flash kernel's precondition (checked here)."""
    b, s, h, d = q.shape
    logits, mask = _flash_logits(q, k, v, causal, window, q_pos, kv_pos)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, _acc(v))
    return out.reshape(b, s, h, d).to(q.dtype)


def flash_attention_fwd_lse_plain(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S_kv, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_pos: Optional[torch.Tensor] = None,
    kv_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_ref``'s output and the log-sum-exp the kernel's
    forward writes for its backward: (B, H, S) in float32 (float64 for
    float64 inputs), natural log,
    ``m + log(max(l, 1e-30))`` over each query's scaled logits (masked
    ones at -1e30, so they add nothing)."""
    b, s, h, d = q.shape
    logits, mask = _flash_logits(q, k, v, causal, window, q_pos, kv_pos)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    lse = m + torch.log(torch.clamp(p.sum(dim=-1), min=1e-30))  # (B, KV, G, S)
    out = torch.einsum("bkgqs,bskd->bqkgd", p / p.sum(-1, keepdim=True).clamp(min=1e-30),
                       _acc(v))
    return out.reshape(b, s, h, d).to(q.dtype), lse.reshape(b, h, s)


def flash_attention_bwd_plain(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S_kv, KV, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, S, H, D) the forward's output
    do: torch.Tensor,  # (B, S, H, D) the gradient of o
    lse: torch.Tensor,  # (B, H, S) float32, the forward's log-sum-exp
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_pos: Optional[torch.Tensor] = None,
    kv_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) in the inputs' dtype: the backward kernel's
    FlashAttention-2 recurrences written out, not autograd.

    - Delta = rowsum(dO * O) in float32;
    - P = exp(S - LSE) from the saved log-sum-exp, 0 where masked;
    - dV = sum over the group's heads of P^T dO;
    - dP = dO V^T, dS = P * (dP - Delta);
    - dQ = scale dS K, dK = scale * (sum over the group's heads) dS^T Q.

    On bfloat16 inputs P is rounded to bfloat16 before dV and dS before
    dQ and dK, as the kernel's tensor-core operands are; in float32
    nothing is rounded."""
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    logits, mask = _flash_logits(q, k, v, causal, window, q_pos, kv_pos)
    lse_g = lse.to(logits.dtype).reshape(b, kv, g, s)
    p = torch.where(mask, torch.exp(logits - lse_g[..., None]), 0.0)  # (B, KV, G, S, S_kv)
    low = q.dtype not in (torch.float32, torch.float64)
    rnd = (lambda x: x.to(q.dtype).float()) if low else (lambda x: x)
    dog = _acc(do.reshape(b, s, kv, g, d))
    delta = (dog * _acc(o.reshape(b, s, kv, g, d))).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", rnd(p), dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, _acc(v))
    ds = rnd(p * (dp - delta[..., None]))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, _acc(k)) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, _acc(q.reshape(b, s, kv, g, d))) * scale
    return dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


BWD_TILE = 64  # the backward's wgmma route: queries and keys per tile, one wgmma M or N


def flash_bwd_tile_live(q_lo: int, k_lo: int, s: int, causal: bool, window, qp=None,
                        kp=None) -> bool:
    """The backward kernel's ``tile_live`` (the forward's tile skip): False
    only when every pair of the (64 queries from ``q_lo``, 64 keys from
    ``k_lo``) tile is masked. With positions ``qp`` / ``kp`` (one row,
    non-decreasing under a causal mask) only the causal skip applies."""
    q_last = min(q_lo + BWD_TILE, s) - 1
    if kp is not None:
        return not (causal and int(kp[k_lo]) > int(qp[q_last]))
    if causal and k_lo > q_last:
        return False
    if window is not None and k_lo + BWD_TILE - 1 <= q_lo - window:
        return False
    return True


def flash_bwd_walks(s: int, skv: int, causal: bool, window, qp=None, kp=None):
    """The wgmma route's walks for one batch row: (for each 64-key tile,
    the query tiles its dK/dV block multiplies, in order: the run
    ``[t_lo, t_hi]`` that ``flash_bwd_tile_live`` keeps, each tile kept
    again; for each 64-query tile, the kv tiles its dQ block multiplies).
    The dK/dV block walks its list once per head of the group."""
    n_q, n_kv = -(-s // BWD_TILE), -(-skv // BWD_TILE)

    def walk(n, live):
        kept = [t for t in range(n) if live(t)]
        return [t for t in range(kept[0], kept[-1] + 1) if live(t)] if kept else []

    dkdv = [walk(n_q, lambda t, kt=kt: flash_bwd_tile_live(
        BWD_TILE * t, BWD_TILE * kt, s, causal, window, qp, kp)) for kt in range(n_kv)]
    dq = [walk(n_kv, lambda t, qt=qt: flash_bwd_tile_live(
        BWD_TILE * qt, BWD_TILE * t, s, causal, window, qp, kp)) for qt in range(n_q)]
    return dkdv, dq


def flash_bwd_head_parts(b: int, skv: int, kv: int, group: int, sms: int) -> int:
    """How many parts the wide route (bf16, 128 < D <= 256) splits each kv
    head's group of query heads into for dK/dV: the smallest divisor of
    ``group`` that gives at least two blocks an SM, ``ceil(S_kv / 64) KV B``
    blocks a part (all ``group`` parts when none does). A function of the
    shape and the SM count alone."""
    blocks = -(-skv // BWD_TILE) * kv * b
    for p in range(1, group + 1):
        if group % p == 0 and blocks * p >= 2 * sms:
            return p
    return group


def flash_bwd_dkdv_steps(s: int, skv: int, h: int, kv: int, parts: int, causal: bool, window,
                         qp=None, kp=None):
    """The dK/dV blocks' steps for one batch row: {(key tile, kv head,
    part): [(query head, query tile), ...] in walk order}. A part takes
    ``h / kv / parts`` consecutive query heads of its kv head's group and
    walks each head's run of ``flash_bwd_walks`` in turn."""
    g = h // kv
    per = g // parts
    kv_walks, _ = flash_bwd_walks(s, skv, causal, window, qp, kp)
    return {(kt, kh, p): [(hq, qt) for hq in range(kh * g + p * per, kh * g + (p + 1) * per)
                          for qt in q_tiles]
            for kt, q_tiles in enumerate(kv_walks) for kh in range(kv) for p in range(parts)}


def flash_attention_bwd_tiled_plain(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S_kv, KV, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, S, H, D) the forward's output
    do: torch.Tensor,  # (B, S, H, D) the gradient of o
    lse: torch.Tensor,  # (B, H, S) float32, the forward's log-sum-exp
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_pos: Optional[torch.Tensor] = None,
    kv_pos: Optional[torch.Tensor] = None,
    parts: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) as the backward's wgmma routes compute them
    (``csrc/flash_attention_bwd.cu``'s ``dkdv_wgmma_kernel`` and
    ``dq_wgmma_kernel``; with ``parts`` the wide route's
    ``dkdv_wide_wgmma_kernel``, ``dkdv_reduce_kernel`` and
    ``dq_wide_wgmma_kernel``), tile by tile in their order: dK and dV of
    each 64-key tile summed, per part, over its run of the group's heads
    in turn (``flash_bwd_dkdv_steps``) and, per head, over the query tiles
    of ``flash_bwd_walks``, then the parts' float32 sums added in order of
    part; dQ of each 64-query tile over its kv tiles. Each step recomputes
    S, P = exp(S scale - LSE) under the element mask, dP and dS = P (dP -
    Delta) on its tile; on bfloat16 inputs P and dS are rounded to
    bfloat16 before they are multiplied, as the kernel's tensor-core
    operands are. Same function as ``flash_attention_bwd_plain``; only the
    order of the float32 sums differs."""
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    _check_flash_args(s, skv, causal, window, q_pos, kv_pos)
    scale = 1.0 / math.sqrt(d)
    low = q.dtype not in (torch.float32, torch.float64)
    rnd = (lambda x: x.to(q.dtype).float()) if low else (lambda x: x)
    qf, kf, vf, dof = (_acc(t) for t in (q, k, v, do))
    delta = (dof * _acc(o)).sum(-1)  # (B, S, H)
    lsef = lse.to(qf.dtype)
    use_pos = q_pos is not None and (causal or window is not None)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    t = BWD_TILE
    for bi in range(b):
        qp = q_pos[bi].long() if use_pos else torch.arange(s)
        kp = kv_pos[bi].long() if use_pos else torch.arange(skv)
        kv_walks, q_walks = flash_bwd_walks(s, skv, causal, window,
                                            qp if use_pos else None, kp if use_pos else None)

        def step(qt, kt, hq):
            """(query slice, key slice, P, dS) of one tile of head hq."""
            qs = slice(t * qt, min(t * qt + t, s))
            ks = slice(t * kt, min(t * kt + t, skv))
            mask = torch.ones((qs.stop - qs.start, ks.stop - ks.start), dtype=torch.bool)
            if causal:
                mask &= kp[ks][None, :] <= qp[qs][:, None]
            if window is not None:
                mask &= kp[ks][None, :] > qp[qs][:, None] - window
            sc = qf[bi, qs, hq] @ kf[bi, ks, hq // g].T * scale
            p = torch.where(mask, torch.exp(sc - lsef[bi, hq, qs][:, None]), 0.0)
            dp = dof[bi, qs, hq] @ vf[bi, ks, hq // g].T
            ds = p * (dp - delta[bi, qs, hq][:, None])
            return qs, ks, rnd(p), rnd(ds)

        dkdv_steps = flash_bwd_dkdv_steps(s, skv, h, kv, parts, causal, window,
                                          qp if use_pos else None, kp if use_pos else None)
        for kt in range(len(kv_walks)):
            ks = slice(t * kt, min(t * kt + t, skv))
            for kh in range(kv):
                part_k, part_v = [], []
                for p_i in range(parts):
                    acc_k = torch.zeros_like(dk[bi, ks, kh])
                    acc_v = torch.zeros_like(dv[bi, ks, kh])
                    for hq, qt in dkdv_steps[(kt, kh, p_i)]:
                        qs, _, p, ds = step(qt, kt, hq)
                        acc_v += p.T @ dof[bi, qs, hq]
                        acc_k += ds.T @ qf[bi, qs, hq]
                    part_k.append(acc_k)
                    part_v.append(acc_v)
                for acc_k, acc_v in zip(part_k, part_v):  # in order of part
                    dk[bi, ks, kh] += acc_k
                    dv[bi, ks, kh] += acc_v
        for qt, k_tiles in enumerate(q_walks):
            for hq in range(h):
                for kt in k_tiles:
                    qs, ks, _, ds = step(qt, kt, hq)
                    dq[bi, qs, hq] += ds @ kf[bi, ks, hq // g]
    return (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def check_flash_masks(s: int, skv: int, causal: bool, window, q_pos, kv_pos) -> None:
    """The argument rules the flash kernel and its plain version share."""
    if skv != s and (causal or window is not None):
        raise ValueError(
            f"S_kv = {skv} != S = {s} is supported without a causal mask or window only"
        )
    if (q_pos is None) != (kv_pos is None):
        raise ValueError("q_pos and kv_pos come together")


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
    causal: bool = True,
) -> torch.Tensor:
    """One query token per row against its cache; ``causal=False``
    (cross-attention) drops the ``kv_pos <= cursor`` term."""
    b, _, h, d = q.shape
    kv = cache_k.shape[2]
    g = h // kv
    qg = q.reshape(b, 1, kv, g, d).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k.float()) / math.sqrt(d)
    cursor = cursor.long()
    kv_pos = kv_pos.long()
    mask = kv_valid.bool()
    if causal:
        mask = mask & (kv_pos <= cursor[:, None])
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
    causal: bool = True,
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
    mask = kv_valid.bool()
    if causal:
        mask = mask & (kv_pos <= cursor[:, None])
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
    (h for every step in a's dtype, last h in float32; float64 throughout
    for float64 inputs)."""
    bsz, s, d = a.shape
    acc = torch.promote_types(a.dtype, torch.float32)
    if h0 is None:
        h = torch.zeros((bsz, d), dtype=acc, device=a.device)
    else:
        h = h0.to(acc)
    af, bf = a.to(acc), b_in.to(acc)
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
    Returns (o in r's dtype, last state in float32; float64 throughout
    for float64 inputs)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    acc = torch.promote_types(r.dtype, torch.float32)
    if state is None:
        st = torch.zeros((b, h, dk, dv), dtype=acc, device=r.device)
    else:
        st = state.to(acc)
    rf, kf, vf, wf = r.to(acc), k.to(acc), v.to(acc), w.to(acc)
    uf = u.to(acc)[None, :, :, None]
    outs = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uf * kv))
        st = wf[:, t, :, :, None] * st + kv
    return torch.stack(outs, dim=1).to(r.dtype), st


def rglru_bwd_plain(
    a: torch.Tensor,  # (B, S, D) the forward's decay
    h: torch.Tensor,  # (B, S, D) the forward's output (h for every step)
    dh: torch.Tensor,  # (B, S, D) the gradient of h
    dh_last: Optional[torch.Tensor] = None,  # (B, D) the gradient of the last h
    h0: Optional[torch.Tensor] = None,  # (B, D) the forward's initial h
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(da, db, dh0) of ``h_t = a_t h_{t-1} + b_t``: the backward kernel's
    reverse-time recurrence written out, not autograd. With g_t the
    gradient of h_t, seeded by ``dh_last``: g_t = dh_t + a_{t+1} g_{t+1},
    db_t = g_t, da_t = g_t h_{t-1} (``h0`` before the first step, zeros
    when absent), dh0 = a_1 g_1. float32 arithmetic (float64 for float64
    inputs); da and db in a's dtype, dh0 in float32 (float64)."""
    bsz, s, d = a.shape
    acc = torch.promote_types(a.dtype, torch.float32)
    af, hf, gf = a.to(acc), h.to(acc), dh.to(acc)
    carry = (torch.zeros((bsz, d), dtype=acc, device=a.device) if dh_last is None
             else dh_last.to(acc))
    prev0 = (torch.zeros((bsz, d), dtype=acc, device=a.device) if h0 is None
             else h0.to(acc))
    da, db = torch.empty_like(af), torch.empty_like(af)
    for t in range(s - 1, -1, -1):
        g = gf[:, t] + carry
        db[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t > 0 else prev0)
        carry = af[:, t] * g
    return da.to(a.dtype), db.to(a.dtype), carry


def _chunk_walk(x: torch.Tensor, chunk: int, fill: float) -> torch.Tensor:
    """(B, S, D) -> (B, n, chunk, D): the walk cut into chunks, the last
    padded with ``fill`` (a step that leaves the recurrence as it is)."""
    bsz, s, d = x.shape
    n = -(-s // chunk)
    pad = x.new_full((bsz, n * chunk - s, d), fill)
    return torch.cat([x, pad], dim=1).reshape(bsz, n, chunk, d)


def _chunk_carries(p: torch.Tensor, e: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """(B, n, D) carries entering each chunk: ``seed``, then P c + E."""
    carries, carry = [], seed
    for k in range(p.shape[1]):
        carries.append(carry)
        carry = p[:, k] * carry + e[:, k]
    return torch.stack(carries, dim=1)


def rglru_chunked_plain(
    a: torch.Tensor,  # (B, S, D) decay in (0, 1)
    b_in: torch.Tensor,  # (B, S, D) gated inputs
    h0: Optional[torch.Tensor] = None,  # (B, D)
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rglru_ref``'s recurrence in the chunked kernel's association:
    per chunk of ``chunk`` steps the product of its decays P (in time
    order) and its end state E from zero; the h entering each chunk
    (h0, then P c + E); then each chunk's walk from its carry. Each
    product and sum rounded on its own, as the kernel's are. Returns (h
    for every step in a's dtype, last h in float32; float64 for float64
    inputs)."""
    bsz, s, d = a.shape
    acc = torch.promote_types(a.dtype, torch.float32)
    af = _chunk_walk(a.to(acc), chunk, 1.0)
    bf = _chunk_walk(b_in.to(acc), chunk, 0.0)
    n = af.shape[1]
    p = torch.ones((bsz, n, d), dtype=acc, device=a.device)
    e = torch.zeros_like(p)
    for t in range(chunk):
        p = p * af[:, :, t]
        e = af[:, :, t] * e + bf[:, :, t]
    seed = torch.zeros((bsz, d), dtype=acc, device=a.device) if h0 is None else h0.to(acc)
    h = _chunk_carries(p, e, seed)
    hs = torch.empty_like(af)
    for t in range(chunk):
        h = af[:, :, t] * h + bf[:, :, t]
        hs[:, :, t] = h
    hs = hs.reshape(bsz, n * chunk, d)[:, :s]
    return hs.to(a.dtype), hs[:, -1]


def rglru_bwd_chunked_plain(
    a: torch.Tensor,  # (B, S, D) the forward's decay
    h: torch.Tensor,  # (B, S, D) the forward's output
    dh: torch.Tensor,  # (B, S, D) the gradient of h
    dh_last: Optional[torch.Tensor] = None,  # (B, D) the gradient of the last h
    h0: Optional[torch.Tensor] = None,  # (B, D) the forward's initial h
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rglru_bwd_plain``'s reverse-time recurrence in the chunked
    backward kernel's association. Time is walked from the last step,
    cut into chunks of ``chunk`` steps from there (the ragged chunk
    reaches t = 0); the carry c (the gradient h_t receives from step t +
    1) obeys c <- a_t (dh_t + c), so per walk chunk P is the product of
    its decays in walk order and E its outgoing carry from zero; the
    carry entering each walk chunk (dh_last, then P c + E); then each
    chunk's walk from its carry writing db = g and da = g h_{t-1}.
    Returns (da, db in a's dtype, dh0 in float32; float64 for float64
    inputs)."""
    bsz, s, d = a.shape
    acc = torch.promote_types(a.dtype, torch.float32)
    zeros = torch.zeros((bsz, d), dtype=acc, device=a.device)
    prev = torch.cat([(zeros if h0 is None else h0.to(acc))[:, None], h.to(acc)[:, :-1]], dim=1)
    ar = _chunk_walk(a.to(acc).flip(1), chunk, 1.0)
    gr = _chunk_walk(dh.to(acc).flip(1), chunk, 0.0)
    pr = _chunk_walk(prev.flip(1), chunk, 0.0)
    n = ar.shape[1]
    p = torch.ones((bsz, n, d), dtype=acc, device=a.device)
    e = torch.zeros_like(p)
    for u in range(chunk):
        p = p * ar[:, :, u]
        e = ar[:, :, u] * (gr[:, :, u] + e)
    carry = _chunk_carries(p, e, zeros if dh_last is None else dh_last.to(acc))
    da, db = torch.empty_like(ar), torch.empty_like(ar)
    for u in range(chunk):
        g = gr[:, :, u] + carry
        db[:, :, u] = g
        da[:, :, u] = g * pr[:, :, u]
        carry = ar[:, :, u] * g
    back = lambda x: x.reshape(bsz, n * chunk, d)[:, :s].flip(1).to(a.dtype)  # noqa: E731
    return back(da), back(db), carry[:, -1]


def wkv6_bwd_plain(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K)
    u: torch.Tensor,  # (H, K)
    do: torch.Tensor,  # (B, S, H, V) the gradient of o
    state: Optional[torch.Tensor] = None,  # (B, H, K, V) the initial state
    d_state: Optional[torch.Tensor] = None,  # (B, H, K, V) the gradient of the last state
) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du, d_state0) of ``wkv6_ref``: the backward
    kernel's reverse-time recurrences written out, not autograd. With G_t
    the gradient of the state after step t (seeded by ``d_state``) and
    S_{t-1} the state entering step t, walking t from last to first:

    - dr_t = do_t (S_{t-1} + diag(u) k_tᵀ v_t)ᵀ;
    - with X = G_t + diag(u) r_tᵀ do_t (the gradient of k_tᵀ v_t):
      dk_t = X v_tᵀ, dv_t = k_t X;
    - dw_t = rowsum(G_t ⊙ S_{t-1});
    - du += r_t ⊙ k_t (do_t · v_t), summed over batch and time;
    - G_{t-1} = diag(w_t) G_t + r_tᵀ do_t; d_state0 = G_0.

    The sequential recurrence's derivative: no clamp on w (the chunked
    forward's ``WKV_LOG_CLAMP`` is not differentiated). float32 arithmetic
    (float64 for float64 inputs); dr, dk, dv in r's dtype, dw in w's, du
    in u's, d_state0 in float32 (float64)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    acc = torch.promote_types(r.dtype, torch.float32)
    rf, kf, vf, wf, df = (x.to(acc) for x in (r, k, v, w, do))
    uf = u.to(acc)[None, :, :, None]  # (1, H, K, 1)
    st = (torch.zeros((b, h, dk, dv), dtype=acc, device=r.device) if state is None
          else state.to(acc))
    states = []  # S_{t-1} for every t
    for t in range(s):
        states.append(st)
        st = wf[:, t, :, :, None] * st + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    g = (torch.zeros((b, h, dk, dv), dtype=acc, device=r.device) if d_state is None
         else d_state.to(acc))
    gr, gk, gv, gw = (torch.empty_like(x) for x in (rf, kf, vf, wf))
    gu = torch.zeros((h, dk), dtype=acc, device=r.device)
    for t in range(s - 1, -1, -1):
        rt, kt, vt, wt, dt = rf[:, t], kf[:, t], vf[:, t], wf[:, t], df[:, t]
        kv = kt[..., :, None] * vt[..., None, :]  # (B, H, K, V)
        gr[:, t] = torch.einsum("bhkv,bhv->bhk", states[t] + uf * kv, dt)
        x = g + uf * (rt[..., :, None] * dt[..., None, :])
        gk[:, t] = torch.einsum("bhkv,bhv->bhk", x, vt)
        gv[:, t] = torch.einsum("bhkv,bhk->bhv", x, kt)
        gw[:, t] = (g * states[t]).sum(-1)
        gu += (rt * kt * (dt * vt).sum(-1, keepdim=True)).sum(0)
        g = wt[..., :, None] * g + rt[..., :, None] * dt[..., None, :]
    return (gr.to(r.dtype), gk.to(k.dtype), gv.to(v.dtype), gw.to(w.dtype), gu.to(u.dtype), g)


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
    o, x, _ = _wkv6_chunks(r, k, v, w, u, state, chunk, half, od, torch.float32)
    return o[:, :, : r.shape[1]].permute(0, 2, 1, 3).to(r.dtype), x


def _wkv6_chunks(r, k, v, w, u, state, chunk, half, od, acc):
    """``wkv6_chunked_plain``'s arithmetic in ``acc`` (float32, or float64
    for float64 inputs), operands split in ``od``. Returns (o as (B, H,
    n chunk, V), the last state, the states entering the chunks as (B, H,
    n, K, V), unrounded)."""

    def rnd(x):
        hi = x.to(od).to(acc)
        return hi + (x - hi).to(od).to(acc)

    b, s, h, dk = r.shape
    dv = v.shape[-1]
    n = -(-s // chunk)
    nh = chunk // half
    pad = n * chunk - s

    def blocks(x, fill):  # (B, S, H, D) -> (B, H, n, nh, half, D) in acc
        x = x.to(acc)
        if pad:
            x = torch.cat([x, x.new_full((b, pad) + x.shape[2:], fill)], dim=1)
        return x.reshape(b, n, nh, half, h, x.shape[-1]).permute(0, 4, 1, 2, 3, 5)

    rr, kk, vv, ww = blocks(r, 0.0), blocks(k, 0.0), blocks(v, 0.0), blocks(w, 1.0)
    uf = u.to(acc)[None, :, None, None, :]
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

    x = (torch.zeros((b, h, dk, dv), dtype=acc, device=r.device)
         if state is None else state.to(acc))
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
        diag = torch.zeros(ri.shape[:-1] + (half,), dtype=acc, device=r.device)
        diag.diagonal(dim1=-2, dim2=-1).copy_((ri * uf * ki).sum(-1))
        f = torch.ones_like(ki[:, :, :, : half - 1])
        for d in range(1, half):
            vals = (ri[:, :, :, d:] * f * ki[:, :, :, : half - d]).sum(-1)
            diag.diagonal(offset=-d, dim1=-2, dim2=-1).copy_(vals)
            f = f[:, :, :, :-1] * wi[:, :, :, d : half - 1]
        outs.append(o + torch.einsum("bhnts,bhnsv->bhntv", rnd(diag), vv[:, :, :, i]))
    o = torch.stack(outs, dim=3).reshape(b, h, n * chunk, dv)
    return o, x, torch.stack(entering, dim=2)
    

def wkv6_bwd_chunked_plain(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K)
    u: torch.Tensor,  # (H, K)
    do: torch.Tensor,  # (B, S, H, V) the gradient of o
    state: Optional[torch.Tensor] = None,  # (B, H, K, V) the initial state
    d_state: Optional[torch.Tensor] = None,  # (B, H, K, V) the gradient of the last state
) -> Tuple[torch.Tensor, ...]:
    """The plain twin of the chunked backward kernel's arithmetic
    (``wkv6_bwd`` on bfloat16 r): the same (dr, dk, dv, dw, du, d_state0)
    as ``wkv6_bwd_plain``, computed chunk-parallel.

    - S_c, the state entering each 64-step chunk: the chunked forward's
      summaries and carry (``_wkv6_chunks``, its operands split hi/lo in
      r's dtype).
    - The same recurrence walked backwards is G_{t-1} = diag(w_t) G_t +
      r_t^T do_t: the chunked forward on the time-reversed inputs (padded
      to whole chunks at the end, then flipped, so that reversed chunk
      n - 1 - c is chunk c) with k, r and do in the places of r, k and v
      and ``d_state`` as the initial state gives G_end, the gradient
      leaving each chunk, d_state0 as its last state, and dv as its
      output (dv_t = k_t G_t + (k_t . (u r_t)) do_t).
    - Each chunk from its S_c and G_end as the walk kernel does, in
      16-step sub-chunks: S forwards, S_{p+1} = diag(prod w) S_p +
      (k B)^T v (B: the product of the sub-chunk's w after each step, k B
      rounded to two parts), each S_p kept as two parts; then G
      backwards from G_end, G_{p-1} = diag(prod w) G_p + (r A)^T do (A:
      the product before each step). With P(s, t), Q(t, s) the products of
      w strictly between s and t, x_t = S_p do_t^T, y_t = G_p v_t^T (G_p
      as two parts) and m[t, s] = do_t . v_s: dr_t = A_t x_t + sum_{s<t}
      P k_s m[t, s] + u k_t m[t, t]; dk_t = B_t y_t + sum_{s>t} Q r_s
      m[s, t] + u r_t m[t, t]; dw_t = rowsum(G_t . S_{t-1}) expanded:
      A_t B_t rowsum(S_p . G_p) + B_t sum_{s<t} P k_s y_s + A_t sum_{s>t} Q
      r_s x_s + sum_{s'<t<s} P(s', t) Q(t, s) r_s k_s' m[s, s'] (never a
      quotient by w); du's partial r_t k_t m[t, t] per (batch row, chunk),
      summed in that order.

    float32 arithmetic (float64 for float64 inputs); dr, dk, dv in r's
    dtype, dw in w's, du in u's, d_state0 in float32 (float64) or None
    without ``state``."""
    acc = torch.promote_types(r.dtype, torch.float32)
    od = r.dtype
    chunk, half, sub = 64, 8, 16  # the kernel's chunk, half and sub-chunk steps
    b, s, h, dk = r.shape
    n = -(-s // chunk)
    pad = n * chunk - s

    def flipped(x, fill):  # padded at the end to whole chunks, time reversed
        if pad:
            x = torch.cat([x, x.new_full((b, pad) + x.shape[2:], fill)], dim=1)
        return torch.flip(x, [1])

    _, _, s_in = _wkv6_chunks(r, k, v, w, u, state, chunk, half, od, acc)
    o_rev, d_state0, g_in = _wkv6_chunks(flipped(k, 0.0), flipped(r, 0.0), flipped(do, 0.0),
                                         flipped(w, 1.0), u, d_state, chunk, half, od, acc)
    gv = torch.flip(o_rev, [2])[:, :, :s].permute(0, 2, 1, 3)  # (B, S, H, V)
    def rnd(x):  # two parts in od, as the kernel stores a tensor-core operand
        hi = x.to(od).to(acc)
        return hi + (x - hi).to(od).to(acc)

    def steps(x, fill):  # (B, S, H, D) -> (B, H, n chunk, D), identity steps past S
        x = x.to(acc)
        if pad:
            x = torch.cat([x, x.new_full((b, pad) + x.shape[2:], fill)], dim=1)
        return x.permute(0, 2, 1, 3)

    rf, kf, vf, wf, df = steps(r, 0.0), steps(k, 0.0), steps(v, 0.0), steps(w, 1.0), steps(do, 0.0)
    uf = u.to(acc)[None]  # (1, H, K)
    gr, gk, gw = torch.zeros_like(rf), torch.zeros_like(kf), torch.zeros_like(wf)
    du_part = torch.zeros((b, n, h, dk), dtype=acc, device=r.device)  # per (b, chunk)
    n_sub = chunk // sub

    def products(w_):  # (B, H, L, K): prefix products before each step, suffix after
        ones = torch.ones_like(w_[:, :, :1])
        pre = torch.cumprod(torch.cat([ones, w_[:, :, :-1]], dim=2), dim=2)
        suf = torch.flip(torch.cumprod(torch.cat([ones, torch.flip(w_, [2])[:, :, :-1]], dim=2),
                                       dim=2), [2])
        return pre, suf

    for c in range(n):
        st = s_in[:, :, c]
        entering = []  # S entering each sub-chunk, as two bf16 parts
        for p in range(n_sub):
            sl = slice(c * chunk + p * sub, c * chunk + (p + 1) * sub)
            entering.append(rnd(st))
            if p + 1 < n_sub:
                _, suf = products(wf[:, :, sl])
                kd = rnd(kf[:, :, sl] * suf)
                st = (suf[:, :, 0] * wf[:, :, sl][:, :, 0])[..., None] * st + torch.einsum(
                    "bhtk,bhtv->bhkv", kd, vf[:, :, sl])
        g = g_in[:, :, n - 1 - c]
        for p in range(n_sub - 1, -1, -1):
            sl = slice(c * chunk + p * sub, c * chunk + (p + 1) * sub)
            r_, k_, w_, v_, d_ = (x[:, :, sl] for x in (rf, kf, wf, vf, df))
            sp = entering[p]
            x_ = torch.einsum("bhkv,bhtv->bhtk", sp, d_)  # S_p do_t^T
            y_ = torch.einsum("bhkv,bhtv->bhtk", rnd(g), v_)  # G_p v_t^T
            m_ = torch.einsum("bhtv,bhsv->bhts", d_, v_)  # m[t, s] = do_t . v_s
            cc = (sp * g).sum(-1)  # (B, H, K)
            pre, suf = products(w_)
            gam = [None] * sub  # sum over s > t of Q(t, s) r_s x_s
            acc_g = torch.zeros_like(cc)
            for t in range(sub - 1, -1, -1):
                gam[t] = acc_g
                acc_g = w_[:, :, t] * acc_g + r_[:, :, t] * x_[:, :, t]
            beta = torch.zeros_like(cc)
            uu = torch.zeros_like(k_)  # uu[s]: sum over s' < t of P(s', t) k_s' m[s, s']
            for t in range(sub):
                q = torch.ones_like(cc)
                acc_d, acc_k = torch.zeros_like(cc), torch.zeros_like(cc)
                for s2 in range(t + 1, sub):
                    qr = q * r_[:, :, s2]
                    acc_d = acc_d + qr * uu[:, :, s2]
                    acc_k = acc_k + qr * m_[:, :, s2, t, None]
                    q = q * w_[:, :, s2]
                mtt = m_[:, :, t, t, None]
                at, bt = pre[:, :, t], suf[:, :, t]
                tg = c * chunk + p * sub + t
                gr[:, :, tg] = at * x_[:, :, t] + uu[:, :, t] + uf * k_[:, :, t] * mtt
                gk[:, :, tg] = bt * y_[:, :, t] + acc_k + uf * r_[:, :, t] * mtt
                gw[:, :, tg] = at * bt * cc + bt * beta + at * gam[t] + acc_d
                du_part[:, c] += r_[:, :, t] * k_[:, :, t] * mtt
                beta = w_[:, :, t] * beta + k_[:, :, t] * y_[:, :, t]
                uu = w_[:, :, t, None] * uu + k_[:, :, t, None] * m_[:, :, :, t, None]
            rd = rnd(r_ * pre)
            g = (pre[:, :, -1] * w_[:, :, -1])[..., None] * g + torch.einsum(
                "bhtk,bhtv->bhkv", rd, d_)
    gr, gk, gw = (x[:, :, :s].permute(0, 2, 1, 3) for x in (gr, gk, gw))
    gu = torch.zeros((h, dk), dtype=acc, device=r.device)
    for part in du_part.reshape(b * n, h, dk):  # over batch and chunk, in order
        gu += part
    return (gr.to(r.dtype), gk.to(k.dtype), gv.to(v.dtype), gw.to(w.dtype), gu.to(u.dtype),
            None if state is None else d_state0)


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMS norm over the last dim with weight ``1 + weight``, as an eager
    float32 chain; the result in x's dtype. With ``gate`` (x's shape) the
    row normalised is ``x * silu(gate)``, in float32."""
    dtype = x.dtype
    x = x.float()
    if gate is not None:
        x = x * F.silu(gate.float())
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layernorm_ref(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Layer norm over the last dim (biased variance), as an eager float32
    chain; the result in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def rownorm_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                  eps: float, center: bool, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The row-norm kernel's function (``kernels/rownorm.py``): layer norm
    when ``center``, else RMS norm (of ``x * silu(gate)`` with a gate)."""
    if center:
        if gate is not None:
            raise ValueError("rownorm's gate is for RMS norm only")
        return layernorm_ref(x, w, b, eps)
    return rmsnorm_ref(x, w, eps, gate)


# ---------------------------------------------------------------------------
# Mamba-2 state-space duality (SSD)
# ---------------------------------------------------------------------------

SSD_CHUNK = 64  # steps per chunk of the chunked kernel (kL in csrc/ssd_chunk.cu)


def ssd_inputs(dt: torch.Tensor, dt_bias: torch.Tensor, a_log: torch.Tensor, acc=torch.float32):
    """(step sizes softplus(dt + dt_bias), decay rates A = -exp(a_log)), in ``acc``."""
    return F.softplus(dt.to(acc) + dt_bias.to(acc)), -torch.exp(a_log.to(acc))


def _heads_of_groups(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., G, N) -> (..., H, N): head h reads group h // (H / G)."""
    return t.repeat_interleave(heads // t.shape[-2], dim=-2)


def ssd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) before the softplus
    dt_bias: torch.Tensor,  # (H,)
    a_log: torch.Tensor,  # (H,)
    b: torch.Tensor,  # (B, S, G, N)
    c: torch.Tensor,  # (B, S, G, N)
    d: torch.Tensor,  # (H,)
    state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2's recurrence, one token at a time, per head h with a P x N
    state: dt = softplus(dt + dt_bias), A = -exp(a_log),
    S_t = exp(dt_t A) S_{t-1} + dt_t x_t (x) B_t, y_t = S_t C_t + D x_t.
    Returns (y in x's dtype, last state in float32; float64 throughout
    for float64 inputs)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    st = (torch.zeros((bsz, h, p, n), dtype=acc, device=x.device) if state is None
          else state.to(acc))
    step, rate = ssd_inputs(dt, dt_bias, a_log, acc)
    xf, df = x.to(acc), d.to(acc)
    bh, ch = _heads_of_groups(b.to(acc), h), _heads_of_groups(c.to(acc), h)
    ys = []
    for t in range(s):
        dtt = step[:, t]  # (B, H)
        st = (torch.exp(dtt * rate)[..., None, None] * st
              + (dtt[..., None] * xf[:, t])[..., None] * bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", st, ch[:, t]) + df[:, None] * xf[:, t])
    return torch.stack(ys, dim=1).to(x.dtype), st


def ssd_chunked_plain(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) before the softplus
    dt_bias: torch.Tensor,  # (H,)
    a_log: torch.Tensor,  # (H,)
    b: torch.Tensor,  # (B, S, G, N)
    c: torch.Tensor,  # (B, S, G, N)
    d: torch.Tensor,  # (H,)
    *,
    chunk: int = SSD_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the chunked ``ssd_chunk`` kernel's arithmetic,
    from a zero state, in float32. S is cut into ``chunk``-step chunks
    (the last one ragged; the result does not depend on the length).
    With a_t = dt_t A and L_t its running sum inside the chunk:

    - each chunk's state contribution sum_s (e^(L_end - L_s) dt_s x_s) (x) B_s
      and its decay e^(L_end), carried chunk by chunk: S_c enters chunk c;
    - y_t = e^(L_t) C_t . S_c + sum_{s<=t} (C_t . B_s) e^(L_t - L_s) dt_s x_s
      + D x_t.

    Returns (y in x's dtype, last state in float32)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    step, rate = ssd_inputs(dt, dt_bias, a_log, f32)
    xf = x.to(f32)
    bh, ch = _heads_of_groups(b.to(f32), h), _heads_of_groups(c.to(f32), h)
    st = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        a = step[:, sl] * rate  # (B, L, H)
        cum = torch.cumsum(a, dim=1)
        w_out = torch.exp(cum[:, -1:] - cum) * step[:, sl]  # (B, L, H)
        scores = torch.einsum("bthn,bshn->bhts", ch[:, sl], bh[:, sl])
        ln = cum.shape[1]
        causal = torch.ones(ln, ln, dtype=torch.bool, device=x.device).tril()
        cum_h = cum.permute(0, 2, 1)  # (B, H, L)
        gap = (cum_h[..., :, None] - cum_h[..., None, :]).masked_fill(~causal, float("-inf"))
        m = scores * torch.exp(gap) * step[:, sl].permute(0, 2, 1)[:, :, None, :]
        y = (torch.einsum("bhts,bshp->bthp", m, xf[:, sl])
             + torch.exp(cum)[..., None] * torch.einsum("bthn,bhpn->bthp", ch[:, sl], st)
             + d.to(f32)[:, None] * xf[:, sl])
        ys.append(y)
        contrib = torch.einsum("bshp,bshn->bhpn", w_out[..., None] * xf[:, sl], bh[:, sl])
        st = torch.exp(cum[:, -1])[..., None, None] * st + contrib
    return torch.cat(ys, dim=1).to(x.dtype), st


def ssd_conv(xbc: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor, heads: int,
             state_size: int, window: Optional[torch.Tensor] = None):
    """Mamba-2's causal depthwise conv and SiLU over xbc (B, S, H P + 2 N),
    in float32: x (B, S, H, P), B and C (B, S, 1, N). ``window`` (B, W - 1,
    H P + 2 N) holds the inputs before the first token (zeros when None)."""
    bsz, s, cc = xbc.shape
    w = conv_w.shape[0]
    f32 = torch.float32
    hist = (torch.zeros((bsz, w - 1, cc), dtype=f32, device=xbc.device) if window is None
            else window.to(f32))
    hist = torch.cat([hist, xbc.to(f32)], dim=1)
    u = sum(hist[:, k:k + s] * conv_w[k].to(f32) for k in range(w)) + conv_b.to(f32)
    u = F.silu(u)
    hp = cc - 2 * state_size
    return (u[..., :hp].unflatten(-1, (heads, hp // heads)),
            u[..., hp:hp + state_size].unflatten(-1, (1, state_size)),
            u[..., hp + state_size:].unflatten(-1, (1, state_size)))


def ssd_chunk_plain(
    xbc: torch.Tensor,  # (B, S, H P + 2 N) before the conv
    conv_w: torch.Tensor,  # (W, H P + 2 N)
    conv_b: torch.Tensor,  # (H P + 2 N,)
    dt: torch.Tensor,  # (B, S, H) before the softplus
    dt_bias: torch.Tensor,  # (H,)
    a_log: torch.Tensor,  # (H,)
    d: torch.Tensor,  # (H,)
    *,
    state_size: int,
    chunk: int = SSD_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``ssd_chunk`` kernel's function: the conv and SiLU (``ssd_conv``,
    float32) from a zero window, then ``ssd_chunked_plain``. Returns (y in
    xbc's dtype, last state in float32)."""
    x, b, c = ssd_conv(xbc, conv_w, conv_b, dt.shape[-1], state_size)
    y, last = ssd_chunked_plain(x, dt, dt_bias, a_log, b, c, d, chunk=chunk)
    return y.to(xbc.dtype), last


def ssd_step_plain(
    xbc: torch.Tensor,  # (B, H P + 2 N) this token's conv inputs (before the conv)
    dt: torch.Tensor,  # (B, H) before the softplus
    conv_state: torch.Tensor,  # (B, W - 1, H P + 2 N) float32, the last W - 1 inputs
    conv_w: torch.Tensor,  # (W, H P + 2 N)
    conv_b: torch.Tensor,  # (H P + 2 N,)
    dt_bias: torch.Tensor,  # (H,)
    a_log: torch.Tensor,  # (H,)
    d: torch.Tensor,  # (H,)
    state: torch.Tensor,  # (B, H, P, N) float32
    active: Optional[torch.Tensor] = None,  # (B,) bool; None = every row
) -> torch.Tensor:
    """One decode token of a Mamba-2 mixer (the ``ssd_step`` kernel's
    function): the causal conv over the carried window and this token's
    inputs, SiLU, then one ``ssd_ref`` step. ``conv_state`` and ``state``
    are updated IN PLACE on the active rows only; a held row keeps both
    and outputs 0. Returns y (B, H P) in xbc's dtype."""
    bsz = xbc.shape[0]
    h, p, n = state.shape[1:]
    f32 = torch.float32
    window = torch.cat([conv_state.to(f32), xbc.to(f32)[:, None]], dim=1)  # (B, W, C)
    conv = F.silu((window * conv_w.to(f32)).sum(dim=1) + conv_b.to(f32))
    x = conv[:, : h * p].reshape(bsz, 1, h, p)
    bc = conv[:, h * p:].reshape(bsz, 1, 2, 1, n)
    y, new = ssd_ref(x, dt[:, None], dt_bias, a_log, bc[:, :, 0], bc[:, :, 1], d, state)
    y = y[:, 0].reshape(bsz, h * p)
    rows = (torch.ones(bsz, dtype=torch.bool, device=xbc.device) if active is None
            else active.to(torch.bool))
    state.copy_(torch.where(rows[:, None, None, None], new, state))
    conv_state.copy_(torch.where(rows[:, None, None], window[:, 1:], conv_state))
    return torch.where(rows[:, None], y, y.new_zeros(())).to(xbc.dtype)
