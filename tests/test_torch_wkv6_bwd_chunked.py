"""The chunked backward of the RWKV-6 recurrence, on the CPU.

``ref.wkv6_bwd_chunked_plain`` repeats the arithmetic of ``wkv6_bwd``'s
chunked design (bf16 r on the card): the states entering each 64-step
chunk from the chunked forward's summaries and carry, the gradients
leaving each chunk, d_state0 and dv from the same kernels on the
time-reversed recurrence, and per chunk the walk that forms dr, dk, dw
(from G_t and S_{t-1}) and du. Held against ``jax.grad`` of the
reference's ``rwkv6_wkv_scan`` in float32 at 2e-5 (the exact chunked
form: no operand rounding; du, a sum of B S terms of both signs, also
within 1e-6 of its terms' magnitudes, as chip_smoke.py holds it) at
ragged S spanning three chunks, with and
without an initial state and a cotangent on the last state; against the
sequential ``wkv6_bwd_plain`` in float64 at 1e-9; and with its operands
split into bf16 hi/lo parts, as the kernel's tensor cores take them,
within the card's 2e-2 of the sequential backward on bf16 inputs.
Inputs from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro_torch.kernels.ref import wkv6_bwd_chunked_plain, wkv6_bwd_plain

TOL = 2e-5
DU_EPS = 1e-6  # chip_smoke.py's share of du's terms' magnitude (float32 summation order)
NAMES = ("dr", "dk", "dv", "dw", "du", "d_state0")


def _inputs(b, s, h, k, seed):
    rng = np.random.default_rng(seed + s + k)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    r, kk, v, do = f(b, s, h, k), f(b, s, h, k), f(b, s, h, k), f(b, s, h, k)
    w = np.exp(-np.exp(-1.0 + 0.5 * f(b, s, h, k))).astype(np.float32)
    u = (0.5 * f(h, k)).astype(np.float32)
    return r, kk, v, w, u, f(b, h, k, k), do, f(b, h, k, k)


CASES = [(s, st, ds) for s in (150, 190) for st in (False, True) for ds in (False, True)]


@pytest.mark.parametrize("s,with_state,with_ds", CASES,
                         ids=[f"S{s}-{'state' if st else 'zero'}-{'ds' if d else 'nods'}"
                              for s, st, d in CASES])
def test_chunked_backward_matches_jax_grad(s, with_state, with_ds):
    r, kk, v, w, u, state, do, ds = _inputs(2, s, 2, 16, seed=22)
    state = state if with_state else None
    ds = ds if with_ds else np.zeros_like(ds)
    args = [jnp.asarray(x) for x in (r, kk, v, w, u)] + [None if state is None
                                                         else jnp.asarray(state)]

    def f(*xs):
        out, last = jrec.rwkv6_wkv_scan(*xs)
        return jnp.sum(out * do) + jnp.sum(last * ds)

    want = jax.grad(f, argnums=tuple(range(6 if with_state else 5)))(*args)
    t = lambda x: None if x is None else torch.from_numpy(x)
    got = wkv6_bwd_chunked_plain(*map(t, (r, kk, v, w, u, do, state)),
                                 t(ds) if with_ds else None)
    assert (got[5] is None) == (not with_state)
    for name, g, wnt in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        if name == "du":
            # du sums B S terms of both signs in float32: two summation
            # orders (per batch row and chunk here, the scan's in JAX)
            # differ by a few float32 eps times the sum of the terms'
            # magnitudes, so du is held as chip_smoke.py holds it: the
            # tolerance plus DU_EPS of that sum.
            terms = np.abs(r * kk * (do * v).sum(-1, keepdims=True)).sum((0, 1))
            bound = TOL * (1 + np.abs(np.asarray(wnt))) + DU_EPS * terms
            assert (np.abs(g.numpy() - np.asarray(wnt)) <= bound).all(), name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("with_state", [False, True])
def test_chunked_backward_matches_sequential_float64(with_state):
    r, kk, v, w, u, state, do, ds = _inputs(2, 150, 3, 8, seed=5)
    d = lambda x: torch.from_numpy(x).double()
    state = d(state) if with_state else None
    args = [d(x) for x in (r, kk, v, w, u, do)] + [state, d(ds)]
    got = wkv6_bwd_chunked_plain(*args)
    want = wkv6_bwd_plain(*args)
    for name, g, wnt in zip(NAMES, got, want):
        if name == "d_state0" and not with_state:
            assert g is None
            continue
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, wnt, atol=1e-9, rtol=1e-9, msg=name)


def test_chunked_backward_split_operands_within_bf16_tolerance():
    """bf16 inputs: the tensor-core operands (decayed keys, scores, the
    states entering each chunk) split into bf16 hi/lo parts, as the
    kernel's are, within 2e-2 of the sequential backward."""
    r, kk, v, w, u, state, do, ds = _inputs(2, 200, 2, 64, seed=9)
    b = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    args = [b(r), b(kk), b(v), torch.from_numpy(w), b(u), b(do), torch.from_numpy(state),
            torch.from_numpy(ds)]
    got = wkv6_bwd_chunked_plain(*args)
    want = wkv6_bwd_plain(*args)
    for name, g, wnt in zip(NAMES, got, want):
        assert g.dtype == wnt.dtype
        torch.testing.assert_close(g.float(), wnt.float(), atol=2e-2, rtol=2e-2, msg=name)
