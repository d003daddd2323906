"""The decode kernel's split over S, held against the JAX package.

``repro_torch.kernels.ref.decode_attention_split_plain`` is the plain twin
of the CUDA kernel's two passes (per-split partials ``(m, l, acc)``, then
their combine in split order); ``plan_splits`` is the wrapper's choice of
the split. Inputs are made from a seed with numpy and fed to the twin and
to the JAX side: the pure-jnp oracle ``repro.kernels.ref`` and the Pallas
kernel through ``repro.kernels.ops`` in interpret mode. Tolerances are the
reference's own: 2e-5 in float32, 2e-2 in bfloat16.

The JAX oracle zeros only ``active=False`` rows; the port also gives
exact 0 for a row whose every slot is masked, so such rows are checked
for exact 0 and the live rows are compared.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels.decode_attention import plan_splits
from repro_torch.kernels.ref import decode_attention_ref, decode_attention_split_plain

DECODE_REF = jax.jit(jref.decode_attention_ref, static_argnames=("window",))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPE = (3, 448, 8, 2, 32)  # (B, S, H, KV, D): 7 tiles of 64 slots
H100_SMS = 132


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _inputs(shape, seed, ring=False):
    b, s, h, kv, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d), np.float32)
    ck = rng.standard_normal((b, s, kv, d), np.float32)
    cv = rng.standard_normal((b, s, kv, d), np.float32)
    if ring:
        cursor = rng.integers(s, 3 * s, size=(b,)).astype(np.int32)
        # Shuffled slot positions in [cursor - s + 1, cursor], -1 = never written.
        pos = np.stack([rng.permutation(s) + c - s + 1 for c in cursor]).astype(np.int32)
        pos[rng.random((b, s)) < 0.25] = -1
        valid = pos >= 0
    else:
        cursor = rng.integers(s // 2, s, size=(b,)).astype(np.int32)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
        valid = pos <= cursor[:, None]
    return q, ck, cv, cursor, pos, valid


def _run(inputs, dtype, n_split, window=None, active=None, pallas=False):
    """(twin output, JAX output) as float32 numpy."""
    jd, td = DTYPES[dtype]
    q, ck, cv, cursor, pos, valid = inputs
    jact = None if active is None else jnp.asarray(active)
    tact = None if active is None else torch.from_numpy(active)
    jfn = jops.decode_attention if pallas else DECODE_REF
    exp = jfn(jnp.asarray(q).astype(jd), jnp.asarray(ck).astype(jd), jnp.asarray(cv).astype(jd),
              jnp.asarray(cursor), jnp.asarray(pos), jnp.asarray(valid), jact, window=window)
    out = decode_attention_split_plain(
        torch.from_numpy(q).to(td), torch.from_numpy(ck).to(td), torch.from_numpy(cv).to(td),
        torch.from_numpy(cursor), torch.from_numpy(pos), torch.from_numpy(valid), tact,
        window=window, n_split=n_split)
    assert out.dtype == td and tuple(out.shape) == q.shape
    return out.float().numpy(), np.asarray(exp.astype(jnp.float32))


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, SHAPE[1] // 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [None, 100])
def test_split_twin_matches_jax_ref(n_split, dtype, window):
    out, exp = _run(_inputs(SHAPE, 3), dtype, n_split, window=window)
    np.testing.assert_allclose(out, exp, atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("n_split", [1, 3, 7])
def test_split_twin_matches_pallas_interpret(n_split):
    out, exp = _run(_inputs(SHAPE, 5), "float32", n_split, window=13, pallas=True)
    np.testing.assert_allclose(out, exp, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,pallas", [("float32", False), ("bfloat16", False),
                                          ("float32", True)])
def test_wholly_dead_splits(dtype, pallas):
    """Cursors early in the cache: every split after the first has no live
    slot (m = -1e30, l = 0) and must weigh nothing, with no NaN."""
    inputs = list(_inputs(SHAPE, 7))
    inputs[3] = np.array([5, 63, 70], np.int32)
    inputs[5] = inputs[4] <= inputs[3][:, None]
    out, exp = _run(inputs, dtype, 7, pallas=pallas)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, exp, atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("n_split", [1, 2, 7])
@pytest.mark.parametrize("pallas", [False, True])
def test_split_ring_sentinels_and_window(n_split, pallas):
    """Shuffled ring positions with -1 sentinels under a window, as a
    recurrentgemma ring presents them."""
    out, exp = _run(_inputs(SHAPE, 9, ring=True), "float32", n_split, window=150, pallas=pallas)
    np.testing.assert_allclose(out, exp, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_split", [1, 3, 7])
def test_split_dead_rows_exact_zero(dtype, n_split):
    """active=False rows and rows whose every slot is masked give exact 0
    from the combine; live rows match the JAX oracle."""
    inputs = list(_inputs(SHAPE, 13))
    inputs[5] = inputs[5].copy()
    inputs[5][2] = False  # row 2: active, nothing valid
    active = np.array([True, False, True])
    out, exp = _run(inputs, dtype, n_split, active=active)
    np.testing.assert_allclose(out[0], exp[0], atol=_tol(dtype), rtol=_tol(dtype))
    assert np.all(out[1] == 0.0) and np.all(out[2] == 0.0)


def test_split_twin_float32_agrees_with_one_pass_plain():
    """In float32 the twin's P rounding is exact, so every split count
    gives the one-pass plain version's answer up to summation order."""
    t = [torch.from_numpy(a) for a in _inputs((2, 300, 4, 1, 64), 17)]
    want = decode_attention_ref(*t, window=57)
    for n in (1, 2, 3, 5):
        got = decode_attention_split_plain(*t, window=57, n_split=n)
        torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


def _cover(s, n, per):
    tiles = -(-s // 64)
    assert n >= 1 and per >= 1
    assert n * per >= tiles  # splits x tiles cover S
    assert (n - 1) * per < tiles  # the last split holds at least one slot


def test_plan_covers_s_and_is_deterministic():
    for b, kv, s, sms in itertools.product([1, 3, 8, 64], [1, 2, 8],
                                           [1, 63, 64, 65, 509, 2048, 4096, 32768],
                                           [1, 8, 132]):
        n, per = plan_splits(b, kv, s, sms)
        assert plan_splits(b, kv, s, sms) == (n, per)
        _cover(s, n, per)
        tiles = -(-s // 64)
        assert n == 1 or per >= 2  # at least two tiles a split once split
        assert n <= max(1, tiles // 2)


def test_plan_at_the_served_shapes():
    """granite-3-2b's decode (B=8, KV=8, 2048 slots) gets about 8 splits
    (512 blocks on 132 SMs); recurrentgemma-9b's ring (B=8, KV=1, 2048
    slots) 16-32; one row of a short cache is not split."""
    n, per = plan_splits(8, 8, 2048, H100_SMS)
    assert (n, per) == (8, 4) and 8 * 8 * n >= 2 * H100_SMS
    n, per = plan_splits(8, 1, 2048, H100_SMS)
    assert 16 <= n <= 32 and per >= 2
    assert plan_splits(8, 8, 64, H100_SMS) == (1, 1)


@pytest.mark.parametrize("shape,n_split", [((2, 448, 8, 2, 32), None), ((8, 2048, 32, 8, 64), None),
                                           ((8, 2048, 16, 1, 256), None), ((2, 63, 4, 1, 8), 1)])
def test_twin_at_the_planned_split_matches_jax_ref(shape, n_split):
    """The twin at the split the wrapper plans for the card (132 SMs), in
    bf16, against the oracle: granite's and recurrentgemma's shapes."""
    b, s, h, kv, d = shape
    n = n_split or plan_splits(b, kv, s, H100_SMS)[0]
    out, exp = _run(_inputs(shape, 21), "bfloat16", n, window=(2048 if d == 256 else None))
    np.testing.assert_allclose(out, exp, atol=2e-2, rtol=2e-2)
