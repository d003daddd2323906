"""The flash attention backward's plain version against the JAX package,
on the CPU.

``flash_attention_bwd_plain`` (the backward kernel's FlashAttention-2
recurrences written out from the saved log-sum-exp) against ``jax.grad``
of the reference's training attention, ``flash_attention_xla`` (and of
``repro.kernels.ref.flash_attention_ref`` where its arange masks cover the
case), in float32 at 2e-5; against autograd through the port's plain
forward at 1e-6; the plain forward's log-sum-exp against ``logsumexp`` of
the masked scores. Inputs come from numpy with a seed. Cases: causal,
windowed, non-causal with S_kv != S (cross-attention) and position-valued
(M-RoPE's temporal stream), GQA groups 1 and 4, S not a multiple of 64.

``flash_attention_bwd_tiled_plain``, the plain twin of the backward's
wgmma route (its 64 x 64 tiles, its walk and skips, its bf16 rounding
points), against the plain version and ``jax.grad`` of
``flash_attention_xla`` at 2e-5 in float32 for every case above and for
ragged S at the tile edges and windows that straddle one; in bfloat16
against the plain version at the GPU tests' 2e-2; and its walk: every
tile it skips wholly masked, the heaviest blocks first in launch order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.attention import flash_attention_xla
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    BWD_TILE,
    flash_attention_bwd_plain,
    flash_attention_bwd_tiled_plain,
    flash_attention_fwd_lse_plain,
    flash_attention_ref,
    flash_bwd_walks,
)

TOL = 2e-5


def _temporal(b, s, rng):
    """Non-decreasing positions per row: text, a run sharing one position
    (an image), then text after a gap; starts at 0."""
    rows = []
    for _ in range(b):
        n = int(rng.integers(2, s // 2))
        p = int(rng.integers(0, s - n))
        gap = int(rng.integers(1, 6))
        rows.append(np.concatenate([np.arange(p), np.full(n, p),
                                    p + gap + np.arange(s - p - n)]))
    return np.stack(rows).astype(np.int32)


# name: (B, S, S_kv, H, KV, D, causal, window, positions)
CASES = {
    "causal-g4": (2, 70, 70, 8, 2, 16, True, None, False),
    "causal-g1": (2, 70, 70, 4, 4, 16, True, None, False),
    "window-g4": (2, 100, 100, 8, 2, 16, True, 17, False),
    "window-g1": (1, 70, 70, 4, 4, 32, True, 9, False),
    "cross-g1": (2, 33, 150, 4, 4, 16, False, None, False),
    "cross-g4": (1, 5, 77, 8, 2, 16, False, None, False),
    "positions-g4": (2, 90, 90, 8, 2, 16, True, None, True),
    "positions-window-g1": (2, 67, 67, 4, 4, 16, True, 11, True),
}


# The wgmma route's tile edges (64 queries, 64 keys): ragged S on both
# sides of an edge, windows that end inside a tile or straddle one.
TILED_CASES = dict(CASES, **{
    "ragged-129-g4": (2, 129, 129, 8, 2, 16, True, None, False),
    "ragged-191-g1": (1, 191, 191, 4, 4, 16, True, None, False),
    "window-64-straddle-g4": (2, 150, 150, 8, 2, 16, True, 64, False),
    "window-70-g1": (1, 200, 200, 4, 4, 8, True, 70, False),
    "cross-ragged-g2": (1, 65, 130, 4, 2, 16, False, None, False),
    "positions-ragged-g4": (2, 129, 129, 8, 2, 16, True, None, True),
    "positions-window-straddle-g8": (1, 140, 140, 8, 1, 16, True, 65, True),
})


def _inputs(case, seed=0):
    b, s, skv, h, kv, d, causal, window, with_pos = case
    rng = np.random.default_rng(seed + s + skv + h)
    q = rng.standard_normal((b, s, h, d), np.float32)
    k = rng.standard_normal((b, skv, kv, d), np.float32)
    v = rng.standard_normal((b, skv, kv, d), np.float32)
    do = rng.standard_normal((b, s, h, d), np.float32)
    pos = _temporal(b, s, rng) if with_pos else None
    return q, k, v, do, pos


def _mask_kw(case, pos):
    kw = dict(causal=case[6], window=case[7])
    if pos is not None:
        kw.update(q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos))
    return kw


def _plain_grads(case):
    q, k, v, do, pos = _inputs(case)
    kw = _mask_kw(case, pos)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd_lse_plain(tq, tk, tv, **kw)
    return flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw), kw


def _jax_grads(case, fn):
    q, k, v, do, pos = _inputs(case)
    b, s, skv = case[0], case[1], case[2]
    qp = jnp.asarray(pos) if pos is not None else jnp.broadcast_to(jnp.arange(s), (b, s))
    kp = jnp.asarray(pos) if pos is not None else jnp.broadcast_to(jnp.arange(skv), (b, skv))

    def f(q, k, v):
        return jnp.sum(fn(q, k, v, qp, kp) * do)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_flash_xla(name):
    case = CASES[name]
    (dq, dk, dv), _ = _plain_grads(case)
    causal, window = case[6], case[7]
    want = _jax_grads(case, lambda q, k, v, qp, kp: flash_attention_xla(
        q, k, v, qp, kp, causal=causal, window=window, kv_chunk=32))
    for grad, got, w in zip(("dQ", "dK", "dV"), (dq, dk, dv), want):
        got, w = got.numpy(), np.asarray(w)
        np.testing.assert_allclose(got, w, atol=TOL, rtol=TOL, err_msg=(
            f"{grad}: finite (port, JAX) {np.isfinite(got).all()}, {np.isfinite(w).all()}"))


@pytest.mark.parametrize("name", ["causal-g4", "causal-g1", "window-g4", "window-g1"])
def test_plain_backward_matches_jax_kernel_oracle(name):
    """The reference's kernel oracle covers arange masks with S_kv == S."""
    case = CASES[name]
    (dq, dk, dv), _ = _plain_grads(case)
    causal, window = case[6], case[7]
    want = _jax_grads(case, lambda q, k, v, qp, kp: jref.flash_attention_ref(
        q, k, v, causal=causal, window=window))
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd(name):
    """The explicit recurrences against autograd through the plain forward
    (which ``ops.flash_attention`` runs for CPU tensors), at 1e-6, in
    float64: the two differ in algorithm only, not in float32 summation
    order (float32 rounding is held against JAX above, at 2e-5)."""
    case = CASES[name]
    q, k, v, do, pos = _inputs(case)
    kw = _mask_kw(case, pos)
    tq, tk, tv, tdo = (torch.from_numpy(x).double() for x in (q, k, v, do))
    o, lse = flash_attention_fwd_lse_plain(tq, tk, tv, **kw)
    dq, dk, dv = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, tdo)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_lse_is_logsumexp_of_scores(name):
    case = CASES[name]
    q, k, v, _, pos = _inputs(case)
    kw = _mask_kw(case, pos)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_fwd_lse_plain(tq, tk, tv, **kw)
    torch.testing.assert_close(out, flash_attention_ref(tq, tk, tv, **kw), atol=1e-6, rtol=1e-6)
    b, s, skv, h, kvh, d, causal, window, _ = case
    kk = np.repeat(k, h // kvh, axis=2)  # (B, S_kv, H, D)
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / math.sqrt(d)
    qp = pos if pos is not None else np.broadcast_to(np.arange(s), (b, s))
    kp = pos if pos is not None else np.broadcast_to(np.arange(skv), (b, skv))
    mask = np.ones((b, s, skv), bool)
    if causal:
        mask &= kp[:, None, :] <= qp[:, :, None]
    if window is not None:
        mask &= kp[:, None, :] > qp[:, :, None] - window
    scores = np.where(mask[:, None], scores, -np.inf)
    mx = scores.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(scores - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)


def test_plain_backward_rounds_bf16_operands():
    """On bfloat16 inputs the plain backward rounds P (before dV) and dS
    (before dQ and dK) as the kernel's tensor-core operands are: it sits
    within bf16 rounding of the float32 result, and returns bf16."""
    case = CASES["causal-g4"]
    (dq, dk, dv), kw = _plain_grads(case)
    q, k, v, do, _ = _inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = flash_attention_fwd_lse_plain(tq, tk, tv, **kw)
    got = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw)
    for g, w in zip(got, (dq, dk, dv)):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, atol=5e-2, rtol=5e-2)


def _tiled_and_plain(case, dtype=torch.float32):
    q, k, v, do, pos = _inputs(case)
    kw = _mask_kw(case, pos)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    o, lse = flash_attention_fwd_lse_plain(tq, tk, tv, **kw)
    args = (tq, tk, tv, o, tdo, lse)
    return flash_attention_bwd_tiled_plain(*args, **kw), flash_attention_bwd_plain(*args, **kw)


@pytest.mark.parametrize("name", sorted(TILED_CASES))
def test_tiled_backward_matches_plain(name):
    """The wgmma route's tile walk against the whole-matrix recurrences:
    the same function, float32 summed in another order (2e-5)."""
    got, want = _tiled_and_plain(TILED_CASES[name])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", sorted(TILED_CASES))
def test_tiled_backward_matches_jax_flash_xla(name):
    case = TILED_CASES[name]
    (dq, dk, dv), _ = _tiled_and_plain(case)
    causal, window = case[6], case[7]
    want = _jax_grads(case, lambda q, k, v, qp, kp: flash_attention_xla(
        q, k, v, qp, kp, causal=causal, window=window, kv_chunk=32))
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["causal-g4", "ragged-129-g4", "window-64-straddle-g4",
                                  "positions-ragged-g4", "cross-g4"])
def test_tiled_backward_rounds_bf16_like_plain(name):
    """On bfloat16 inputs the twin rounds P and dS where the kernel does,
    tile by tile: within the GPU tests' bf16 tolerance (2e-2) of the
    plain version, which rounds at the same points over whole matrices."""
    got, want = _tiled_and_plain(TILED_CASES[name], torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", sorted(TILED_CASES))
def test_tile_walk_skips_only_masked_tiles(name):
    """Every (query tile, key tile) that a walk leaves out is wholly
    masked, and each walk is ascending; for arange causal masks the dK/dV
    walks shorten with the key tile and the dQ walks lengthen with the
    query tile, so the kernels' launch orders (first keys, last queries
    first) start the longest blocks first."""
    b, s, skv, h, kvh, d, causal, window, with_pos = TILED_CASES[name]
    _, _, _, _, pos = _inputs(TILED_CASES[name])
    for bi in range(b):
        qp = np.asarray(pos[bi]) if with_pos else np.arange(s)
        kp = np.asarray(pos[bi]) if with_pos else np.arange(skv)
        mask = np.ones((s, skv), bool)
        if causal:
            mask &= kp[None, :] <= qp[:, None]
        if window is not None:
            mask &= kp[None, :] > qp[:, None] - window
        walks = flash_bwd_walks(s, skv, causal, window, qp if with_pos else None,
                                kp if with_pos else None)
        dkdv, dq = walks
        t = BWD_TILE
        tile = lambda qt, kt: mask[t * qt:t * qt + t, t * kt:t * kt + t]
        for kt, q_tiles in enumerate(dkdv):
            assert q_tiles == sorted(set(q_tiles))
            for qt in range(-(-s // t)):
                if qt not in q_tiles:
                    assert not tile(qt, kt).any(), (name, "dkdv", kt, qt)
        for qt, k_tiles in enumerate(dq):
            assert k_tiles == sorted(set(k_tiles))
            for kt in range(-(-skv // t)):
                if kt not in k_tiles:
                    assert not tile(qt, kt).any(), (name, "dq", qt, kt)
        assert sum(map(len, dkdv)) == sum(map(len, dq))  # the same tiles, by keys or by queries
        if causal and not with_pos and window is None:
            assert [len(w) for w in dkdv] == sorted((len(w) for w in dkdv), reverse=True)
            assert [len(w) for w in dq] == sorted(len(w) for w in dq)
