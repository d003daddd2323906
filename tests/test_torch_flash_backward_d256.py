"""The flash backward's wide route (bf16, 128 < D <= 256) on the CPU.

``flash_attention_bwd_tiled_plain`` with ``parts`` walks the route's
tiles as ``dkdv_wide_wgmma_kernel``, ``dkdv_reduce_kernel`` and
``dq_wide_wgmma_kernel`` do: each kv head's group of query heads split
into ``parts`` runs of consecutive heads, each run's dK/dV summed in
float32 on its own, the runs added in order of part, P^T and dS^T rounded
to bf16 where they are tensor-core operands. At D = 256 with a causal
window, for MQA (H = 16, KV = 1, recurrentgemma-9b's layout) and GQA
(H = 16, KV = 8, gemma3-12b's), held against ``flash_attention_bwd_plain``
and ``jax.grad`` of the reference's ``flash_attention_xla`` at 2e-5 in
float32, and in bfloat16 against the plain version at 2e-2. The walk:
every live (key tile, query head, query tile) is visited exactly once
across the parts, and ``flash_bwd_head_parts`` (the split rule) at the
training shapes. Inputs from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention_xla
from repro_torch.kernels.ref import (
    BWD_TILE,
    flash_attention_bwd_plain,
    flash_attention_bwd_tiled_plain,
    flash_attention_fwd_lse_plain,
    flash_bwd_dkdv_steps,
    flash_bwd_head_parts,
    flash_bwd_tile_live,
)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
H100_SMS = 132

# name: (B, S, H, KV, D, window)
CASES = {
    "mqa-window": (1, 256, 16, 1, 256, 128),
    "gqa-window": (1, 256, 16, 8, 256, 128),
    "mqa-ragged": (2, 200, 4, 1, 136, 70),
}


def _inputs(case, seed=22):
    b, s, h, kv, d, _ = case
    rng = np.random.default_rng(seed + s + h + kv + d)
    q = rng.standard_normal((b, s, h, d), np.float32)
    k = rng.standard_normal((b, s, kv, d), np.float32)
    v = rng.standard_normal((b, s, kv, d), np.float32)
    do = rng.standard_normal((b, s, h, d), np.float32)
    return q, k, v, do


def _grads(case, parts, dtype=torch.float32):
    q, k, v, do = _inputs(case)
    kw = dict(causal=True, window=case[5])
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    o, lse = flash_attention_fwd_lse_plain(tq, tk, tv, **kw)
    args = (tq, tk, tv, o, tdo, lse)
    return (flash_attention_bwd_tiled_plain(*args, parts=parts, **kw),
            flash_attention_bwd_plain(*args, **kw))


def _parts_of(case):
    g = case[2] // case[3]
    return [p for p in (1, 2, 4, 8, 16) if g % p == 0]


PARAMS = [(n, p) for n in sorted(CASES) for p in _parts_of(CASES[n])]


@pytest.mark.parametrize("name,parts", PARAMS)
def test_wide_walk_matches_plain(name, parts):
    got, want = _grads(CASES[name], parts)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=TOL[torch.float32], rtol=TOL[torch.float32])


@pytest.mark.parametrize("name", sorted(CASES))
def test_wide_walk_matches_jax_flash_xla(name):
    case = CASES[name]
    b, s = case[0], case[1]
    parts = flash_bwd_head_parts(b, s, case[3], case[2] // case[3], H100_SMS)
    (dq, dk, dv), _ = _grads(case, parts)
    q, k, v, do = _inputs(case)
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))

    def f(q, k, v):
        return jnp.sum(flash_attention_xla(q, k, v, pos, pos, causal=True, window=case[5],
                                           kv_chunk=64) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32])


@pytest.mark.parametrize("name,parts", [("mqa-window", 8), ("gqa-window", 1),
                                        ("mqa-ragged", 4)])
def test_wide_walk_rounds_bf16_like_plain(name, parts):
    """bf16 inputs: P^T and dS^T rounded where the kernels round them,
    tile by tile and part by part, within 2e-2 of the plain version."""
    got, want = _grads(CASES[name], parts, torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=TOL[torch.bfloat16],
                                   rtol=TOL[torch.bfloat16])


@pytest.mark.parametrize("name,parts", PARAMS)
def test_every_live_tile_is_walked_once_across_parts(name, parts):
    b, s, h, kv, d, window = CASES[name]
    steps = flash_bwd_dkdv_steps(s, s, h, kv, parts, True, window)
    n = -(-s // BWD_TILE)
    g = h // kv
    visited = [(kt, hq, qt) for (kt, kh, p), walk in steps.items() for hq, qt in walk]
    live = {(kt, hq, qt) for kt in range(n) for hq in range(h) for qt in range(n)
            if flash_bwd_tile_live(BWD_TILE * qt, BWD_TILE * kt, s, True, window)}
    assert len(visited) == len(set(visited)) and set(visited) == live
    for (kt, kh, p), walk in steps.items():
        heads = sorted({hq for hq, _ in walk})
        # A part walks its own run of the group's heads, one head after another.
        assert all(kh * g + p * (g // parts) <= hq < kh * g + (p + 1) * (g // parts)
                   for hq in heads)
        assert [hq for hq, _ in walk] == sorted(hq for hq, _ in walk)


def test_head_parts_rule():
    # recurrentgemma-9b's local attention (B 1, S 4096, MQA 16 / 1): 64 key
    # blocks on 132 SMs, split 8 ways; gemma3-12b (GQA 16 / 8): 512 blocks,
    # no split.
    assert flash_bwd_head_parts(1, 4096, 1, 16, H100_SMS) == 8
    assert flash_bwd_head_parts(1, 4096, 8, 2, H100_SMS) == 1
    for b, skv, kv, g in [(1, 4096, 1, 16), (1, 256, 1, 16), (2, 1000, 2, 6), (8, 512, 4, 3),
                          (1, 64, 1, 1)]:
        p = flash_bwd_head_parts(b, skv, kv, g, H100_SMS)
        blocks = -(-skv // 64) * kv * b
        assert g % p == 0
        assert blocks * p >= 2 * H100_SMS or p == g
        assert all(blocks * q < 2 * H100_SMS for q in range(1, p) if g % q == 0)
