"""The port's plain attention kernels against the JAX package.

Each case makes its inputs from a seed with numpy and feeds the same
arrays to ``repro_torch`` (CPU tensors, so ``ops`` runs the plain
versions) and to ``repro``: the pure-jnp oracles in ``repro.kernels.ref``
and the Pallas kernels through ``repro.kernels.ops`` in interpret mode,
as ``tests/test_kernels.py`` runs them. Shape sweeps are that file's.
Tolerances are the reference's own: 2e-5 in float32, 2e-2 in bfloat16.

Dead rows: the port gives exact 0 for any decode row with no live slot;
the JAX oracle zeros only ``active=False`` rows, so rows that are live
are compared and dead rows are checked for exact 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain

FLASH_SHAPES = [
    # (B, S, H, KV, D)
    (1, 16, 4, 4, 16),
    (2, 100, 8, 2, 32),
    (1, 256, 4, 1, 64),
    (2, 67, 6, 2, 128),
    (1, 300, 2, 2, 256),
]
DECODE_SHAPES = [
    (2, 70, 8, 2, 32),
    (1, 256, 4, 4, 64),
    (3, 33, 6, 1, 128),
    (2, 500, 16, 2, 64),
]
MASKS = [(True, None), (True, 23), (False, None)]
# The oracles jitted once per shape (op-by-op dispatch of the unjitted
# functions costs about a second per case on the CPU).
FLASH_REF = jax.jit(jref.flash_attention_ref, static_argnames=("causal", "window"))
DECODE_REF = jax.jit(jref.decode_attention_ref, static_argnames=("window",))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _pair(arr, name):
    jd, td = DTYPES[name]
    return jnp.asarray(arr).astype(jd), torch.from_numpy(arr).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _flash_inputs(shape, seed):
    b, s, h, kv, d = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, s, kv, d), np.float32),
            rng.standard_normal((b, s, kv, d), np.float32))


# Every sweep shape in both dtypes; the three mask modes rotate over the
# shapes (each JAX compile costs a fraction of a second on the CPU).
@pytest.mark.parametrize("shape,causal,window", [
    (shape,) + MASKS[i % 3] for i, shape in enumerate(FLASH_SHAPES)
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_matches_jax_ref(shape, dtype, causal, window):
    q, k, v = (_pair(a, dtype) for a in _flash_inputs(shape, 7))
    exp = FLASH_REF(q[0], k[0], v[0], causal=causal, window=window)
    out = tops.flash_attention(q[1], k[1], v[1], causal=causal, window=window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == q[1].shape
    np.testing.assert_allclose(_f32(out), _f32(exp), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("shape,causal,window", [
    (FLASH_SHAPES[0], True, None),
    (FLASH_SHAPES[1], True, 23),
    (FLASH_SHAPES[2], False, None),
    (FLASH_SHAPES[3], True, 23),
    (FLASH_SHAPES[4], True, None),
])
def test_flash_plain_matches_pallas_interpret(shape, causal, window):
    q, k, v = (_pair(a, "float32") for a in _flash_inputs(shape, 11))
    exp = jops.flash_attention(q[0], k[0], v[0], causal=causal, window=window)
    out = flash_attention_plain(q[1], k[1], v[1], causal=causal, window=window)
    np.testing.assert_allclose(_f32(out), _f32(exp), atol=2e-5, rtol=2e-5)


def _decode_inputs(shape, seed, ring=False):
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


def _run_both(inputs, dtype, active, window, pallas=False):
    q, ck, cv, cursor, pos, valid = inputs
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(ck, dtype)
    jv, tv = _pair(cv, dtype)
    jact = None if active is None else jnp.asarray(active)
    tact = None if active is None else torch.from_numpy(active)
    jfn = jops.decode_attention if pallas else DECODE_REF
    exp = jfn(jq, jk, jv, jnp.asarray(cursor), jnp.asarray(pos), jnp.asarray(valid),
              jact, window=window)
    out = tops.decode_attention(
        tq, tk, tv, torch.from_numpy(cursor), torch.from_numpy(pos),
        torch.from_numpy(valid), tact, window=window)
    return _f32(out), _f32(exp)


@pytest.mark.parametrize("shape,window", [
    (shape, (None, 13)[i % 2]) for i, shape in enumerate(DECODE_SHAPES)
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_jax_ref(shape, dtype, window):
    out, exp = _run_both(_decode_inputs(shape, 3), dtype, None, window)
    np.testing.assert_allclose(out, exp, atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("shape,window", list(zip(DECODE_SHAPES, [None, 13, 13, None])))
def test_decode_plain_matches_pallas_interpret(shape, window):
    out, exp = _run_both(_decode_inputs(shape, 5), "float32", None, window, pallas=True)
    np.testing.assert_allclose(out, exp, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pallas", [False, True])
def test_decode_ring_cache_semantics(pallas):
    """Shuffled ring positions with -1 sentinels and a window: the plain
    version honours them exactly like the oracle and the Pallas kernel."""
    inputs = _decode_inputs((2, 64, 4, 2, 32), 9, ring=True)
    out, exp = _run_both(inputs, "float32", None, 40, pallas=pallas)
    np.testing.assert_allclose(out, exp, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pallas", [False, True])
def test_decode_dead_rows_exact_zero(dtype, pallas):
    """active=False rows and rows whose every slot is masked give exact 0;
    live rows match the JAX side."""
    shape = (4, 70, 8, 2, 32)
    q, ck, cv, cursor, pos, valid = _decode_inputs(shape, 13)
    valid[2] = False  # row 2: active but nothing valid — dead by mask
    active = np.array([True, False, True, True])
    out, exp = _run_both((q, ck, cv, cursor, pos, valid), dtype, active, None,
                         pallas=pallas)
    live = [0, 3]
    np.testing.assert_allclose(out[live], exp[live], atol=_tol(dtype), rtol=_tol(dtype))
    assert np.all(out[1] == 0.0) and np.all(out[2] == 0.0)
    assert np.all(exp[1] == 0.0)  # the JAX side zeros the inactive row too


def test_plain_versions_are_what_ops_runs_on_cpu():
    inputs = _decode_inputs(DECODE_SHAPES[0], 17)
    t = [torch.from_numpy(a) for a in inputs]
    a = tops.decode_attention(*t, window=13)
    b = decode_attention_plain(*t, window=13)
    assert torch.equal(a, b)
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(FLASH_SHAPES[1], 19))
    assert torch.equal(tops.flash_attention(q, k, v, window=23),
                       flash_attention_plain(q, k, v, window=23))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its CUDA kernel or raises; it never computes on
    the CPU itself (the CPU path is ``ops`` choosing the plain version)."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(FLASH_SHAPES[0], 1))
    before = (dk.launches, fk.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention(q, k, v)
    t = [torch.from_numpy(a) for a in _decode_inputs(DECODE_SHAPES[0], 1)]
    with pytest.raises(ValueError, match="CUDA"):
        dk.decode_attention(*t)
    from repro_torch.kernels import flash_attention_bwd as fb

    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_attention_bwd(q, k, v, q, q, torch.zeros(q.shape[0], q.shape[2], q.shape[1]))
    from repro_torch.kernels import rglru_bwd as rb
    from repro_torch.kernels import wkv6_bwd as wb

    r = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        wb.wkv6_bwd(r, r, r, r, torch.zeros((2, 8)), r)
    a = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rb.rglru_bwd(a, a, a)
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import ssd_step as ss

    h = torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        sc.ssd_chunk(torch.zeros((1, 4, 48)), torch.zeros((4, 48)), torch.zeros(48),
                     torch.zeros((1, 4, 2)), h, h, h, state_size=16)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_step(torch.zeros((1, 48)), torch.zeros((1, 2)), torch.zeros((1, 3, 48)),
                    torch.zeros((4, 48)), torch.zeros(48), h, h, h, torch.zeros((1, 2, 8, 16)))
    assert (dk.launches, fk.launches, sc.launches, ss.launches) == before + (0, 0)
    counts = tops.launch_counts()
    assert set(counts) == {"decode_attention", "flash_attention", "flash_attention_bwd", "wkv6",
                           "wkv6_bwd", "rglru_scan", "rglru_bwd", "rownorm", "ssd_chunk",
                           "ssd_step"}
    assert (counts["decode_attention"], counts["flash_attention"]) == before
    assert counts["wkv6_bwd"] == counts["rglru_bwd"] == 0
