"""The two recurrences' backward plain versions against the JAX package,
on the CPU.

``wkv6_bwd_plain`` and ``rglru_bwd_plain`` (the backward kernels'
reverse-time recurrences written out, ``repro_torch.kernels.ref``) against
``jax.grad`` of the reference's scans in float32 at 2e-5: RWKV-6's
``repro.models.recurrent.rwkv6_wkv_scan`` with cotangents on the output
and on the last state, with and without an initial state, S in {1, 37,
64, 130}, K = V in {16, 64}; RG-LRU's ``repro.kernels.ref.rglru_ref``
with and without h0, and ``repro.models.recurrent.rglru_prefill`` (its
associative scan and h0 fold included) against the port's
``rglru_gates`` composed with a test-local ``autograd.Function`` over the
plain pair. Both against autograd through the port's plain forwards in
float64 at 1e-6. The clamp case: where w < e^-60 the chunked forward
(log w clamped at -60) computes a function with no gradient in w, while
the sequential derivative has one; everything else agrees. Tiny
rwkv6 and recurrentgemma models with the recurrences routed through that
Function pair: loss and every gradient leaf against
``jax.value_and_grad`` of the reference's loss. Inputs come from numpy
with a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as jtiny
from repro.kernels import ref as jref
from repro.models import model_for as jmodel_for
from repro.models import recurrent as jrec
from repro_torch import interop
from repro_torch.checkpoint.checkpoint import leaf_paths
from repro_torch.configs.registry import tiny
from repro_torch.kernels import _build, ops
from repro_torch.kernels.ref import (
    WKV_LOG_CLAMP,
    rglru_bwd_plain,
    rglru_ref,
    wkv6_bwd_chunked_plain,
    wkv6_bwd_plain,
    wkv6_chunked_plain,
    wkv6_ref,
)
from repro_torch.models import model_for
from repro_torch.models import recurrent as trec
from repro_torch.models.layers import tree_leaves
from repro_torch.training import train_loop as ttl

TOL = 2e-5


def _wkv_inputs(b, s, h, k, with_state, seed=0, log_w=None):
    """r, k, v, w, u, state, do, d_state as float32 numpy; w = exp(-exp(x))
    as the model makes it (x ~ N(-1, 0.5), or ``log_w`` given)."""
    rng = np.random.default_rng(seed + 1000 * s + k + with_state)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    r, kk, v, do = f(b, s, h, k), f(b, s, h, k), f(b, s, h, k), f(b, s, h, k)
    x = -1.0 + 0.5 * f(b, s, h, k) if log_w is None else log_w(rng, (b, s, h, k))
    w = np.exp(-np.exp(x)).astype(np.float32)
    u = (0.5 * f(h, k)).astype(np.float32)
    state = f(b, h, k, k) if with_state else None
    return r, kk, v, w, u, state, do, f(b, h, k, k)


def _jax_wkv_grads(r, k, v, w, u, state, do, ds):
    args = [jnp.asarray(x) for x in (r, k, v, w, u)]
    args.append(None if state is None else jnp.asarray(state))

    def f(*xs):
        out, last = jrec.rwkv6_wkv_scan(*xs)
        return jnp.sum(out * do) + jnp.sum(last * ds)

    argnums = tuple(range(6 if state is not None else 5))
    return jax.grad(f, argnums=argnums)(*args)


WKV_CASES = [(s, k, st) for s in (1, 37, 64, 130) for k in (16, 64) for st in (False, True)]


@pytest.mark.parametrize("s,k,with_state", WKV_CASES,
                         ids=[f"S{s}-K{k}-{'state' if st else 'zero'}" for s, k, st in WKV_CASES])
def test_wkv6_bwd_plain_matches_jax_grad(s, k, with_state):
    r, kk, v, w, u, state, do, ds = _wkv_inputs(2, s, 2, k, with_state)
    t = lambda x: None if x is None else torch.from_numpy(x)
    got = wkv6_bwd_plain(*map(t, (r, kk, v, w, u, do, state, ds)))
    want = _jax_wkv_grads(r, kk, v, w, u, state, do, ds)
    names = ("dr", "dk", "dv", "dw", "du", "d_state0")
    assert len(want) == (6 if with_state else 5)
    for name, g, wnt in zip(names, got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=TOL, rtol=TOL, err_msg=name)


def _rglru_inputs(b, s, d, with_h0, seed=0):
    rng = np.random.default_rng(seed + s + d + with_h0)
    a = rng.uniform(0.5, 0.999, (b, s, d)).astype(np.float32)
    bb = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((b, s, d)).astype(np.float32)
    dlast = rng.standard_normal((b, d)).astype(np.float32)
    return a, bb, h0, dh, dlast


@pytest.mark.parametrize("s", [1, 37, 130])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_plain_matches_jax_grad_of_rglru_ref(s, with_h0):
    a, bb, h0, dh, dlast = _rglru_inputs(2, s, 24, with_h0)
    args = [jnp.asarray(a), jnp.asarray(bb)] + ([jnp.asarray(h0)] if with_h0 else [])

    def f(*xs):
        hs, last = jref.rglru_ref(*xs)
        return jnp.sum(hs * dh) + jnp.sum(last * dlast)

    want = jax.grad(f, argnums=tuple(range(len(args))))(*args)
    h, _ = rglru_ref(torch.from_numpy(a), torch.from_numpy(bb),
                     None if h0 is None else torch.from_numpy(h0))
    da, db, dh0 = rglru_bwd_plain(torch.from_numpy(a), h, torch.from_numpy(dh),
                                  torch.from_numpy(dlast),
                                  None if h0 is None else torch.from_numpy(h0))
    got = (da, db, dh0)[:len(want)]
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)


class _PlainRGLRU(torch.autograd.Function):
    """The plain pair as one differentiable op: ``rglru_ref`` forward,
    ``rglru_bwd_plain`` backward (the kernels' structure on the CPU)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, last = rglru_ref(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, last

    @staticmethod
    def backward(ctx, dh, dlast):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_bwd_plain(a, h, dh, dlast, h0)
        return da, db, None if h0 is None else dh0


class _PlainWKV6(torch.autograd.Function):
    """``wkv6_ref`` forward, ``wkv6_bwd_plain`` backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return wkv6_ref(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, do, ds):
        r, k, v, w, u, state = ctx.saved_tensors
        grads = wkv6_bwd_plain(r, k, v, w, u, do, state, ds)
        return grads[:5] + ((grads[5] if state is not None else None),)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_plain_through_gates_matches_jax_grad_of_rglru_prefill(with_h0):
    """The whole RG-LRU layer: gates, recurrence, h0. The reference folds
    h0 into b_1 and runs an associative scan; the port's plain pair takes
    h0 itself and runs the sequential recurrence."""
    rng = np.random.default_rng(7 + with_h0)
    b, s, d = 2, 45, 16
    p = {"w_a": 0.3 * rng.standard_normal((d, d)), "b_a": 0.1 * rng.standard_normal(d),
         "w_x": 0.3 * rng.standard_normal((d, d)), "b_x": 0.1 * rng.standard_normal(d),
         "lam": 1.0 + 0.3 * rng.standard_normal(d)}
    p = {n: x.astype(np.float32) for n, x in p.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((b, s, d)).astype(np.float32)
    dlast = rng.standard_normal((b, d)).astype(np.float32)

    def f(jp, jx, jh0):
        hs, last = jrec.rglru_prefill(jp, jx, jh0)
        return jnp.sum(hs * dh) + jnp.sum(last * dlast)

    jp = {n: jnp.asarray(v) for n, v in p.items()}
    jh0 = None if h0 is None else jnp.asarray(h0)
    argnums = (0, 1, 2) if with_h0 else (0, 1)
    want = jax.grad(f, argnums=argnums)(jp, jnp.asarray(x), jh0)

    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    a, bb = trec.rglru_gates(tp, tx)
    hs, last = _PlainRGLRU.apply(a, bb, th0)
    loss = (hs * torch.from_numpy(dh)).sum() + (last * torch.from_numpy(dlast)).sum()
    leaves = [tp[n] for n in sorted(p)] + [tx] + ([th0] if with_h0 else [])
    got = torch.autograd.grad(loss, leaves)
    want_flat = [want[0][n] for n in sorted(p)] + list(want[1:])
    for name, g, w in zip(sorted(p) + ["x", "h0"], got, want_flat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_bwd_plain_matches_autograd_float64(with_state):
    """The explicit recurrences against autograd through ``wkv6_ref`` in
    float64: the algorithms agree, not float32 summation order."""
    r, kk, v, w, u, state, do, ds = _wkv_inputs(2, 37, 3, 8, with_state, seed=3)
    d = lambda x: None if x is None else torch.from_numpy(x).double()
    ins = [d(x) for x in (r, kk, v, w, u, state)]
    leaves = [x.clone().requires_grad_() if x is not None else None for x in ins]
    out, last = wkv6_ref(*leaves)
    req = [x for x in leaves if x is not None]
    want = torch.autograd.grad((out * d(do)).sum() + (last * d(ds)).sum(), req)
    got = wkv6_bwd_plain(*ins[:5], d(do), ins[5], d(ds))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, wnt, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_plain_matches_autograd_float64(with_h0):
    a, bb, h0, dh, dlast = _rglru_inputs(3, 29, 11, with_h0, seed=5)
    d = lambda x: None if x is None else torch.from_numpy(x).double()
    leaves = [d(x).requires_grad_() for x in (a, bb)] + ([d(h0).requires_grad_()] if with_h0
                                                          else [])
    h, last = rglru_ref(*leaves)
    want = torch.autograd.grad((h * d(dh)).sum() + (last * d(dlast)).sum(), leaves)
    got = rglru_bwd_plain(d(a), h.detach(), d(dh), d(dlast), d(h0))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_wkv6_clamp_case_dw_departs_only_below_the_clamp():
    """w below e^-60: the chunked forward clamps log w at -60
    (``WKV_LOG_CLAMP``; ``wkv6_chunked_plain`` is its twin), i.e. it
    computes the recurrence on max(w, e^-60), which has no gradient in w
    there, while the backward kernel differentiates the sequential
    recurrence on w itself (as the reference's ``jax.grad`` does) and
    gives ``rowsum(G_t ⊙ S_{t-1})``. Stated and bounded, in float64: the
    clamped and unclamped forwards differ by the clamp's e^-60 effect
    (within 1e-6); dr, dk, dv, du and d_state0 agree at 1e-6; dw agrees at
    1e-6 wherever w > e^-50 and departs only where w < e^-70, where the
    clamped function's is exactly 0 and the sequential derivative's is
    not. The sequential dw there is the reference's (float32, 2e-5), and
    the chunked backward's twin gives it too (1e-6, every gradient)."""
    def log_w(rng, shape):  # x = log(-log w): about a third of w at e^-80
        x = -1.0 + 0.5 * rng.standard_normal(shape)
        return np.where(rng.random(shape) < 0.3, np.log(80.0), x).astype(np.float32)

    r, kk, v, w, u, state, do, ds = _wkv_inputs(2, 70, 2, 8, True, seed=11, log_w=log_w)
    d = lambda x: torch.from_numpy(x).double()
    ins = [d(x) for x in (r, kk, v, w, u, state)]
    below = ins[3] < np.exp(-70.0)
    above = ins[3] > np.exp(-50.0)
    assert bool(below.any()) and bool((below | above).all())
    leaves = [x.clone().requires_grad_() for x in ins]
    clamped = leaves[:3] + [torch.clamp(leaves[3], min=float(np.exp(WKV_LOG_CLAMP)))] + leaves[4:]
    out, last = wkv6_ref(*clamped)
    ref_out, ref_last = wkv6_ref(*ins)
    torch.testing.assert_close(out, ref_out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(last, ref_last, atol=1e-6, rtol=1e-6)
    # The chunked twin computes the clamped function (float32 inside).
    tw_out, _ = wkv6_chunked_plain(*(x.float() for x in ins))
    torch.testing.assert_close(tw_out.double(), out.detach(), atol=1e-4, rtol=1e-4)
    twin = torch.autograd.grad((out * d(do)).sum() + (last * d(ds)).sum(), leaves)
    seq = wkv6_bwd_plain(*ins[:5], d(do), ins[5], d(ds))
    for name, i in (("dr", 0), ("dk", 1), ("dv", 2), ("du", 4), ("d_state0", 5)):
        torch.testing.assert_close(seq[i], twin[i], atol=1e-6, rtol=1e-6, msg=name)
    torch.testing.assert_close(seq[3][above], twin[3][above], atol=1e-6, rtol=1e-6)
    assert bool((twin[3][below] == 0).all())
    assert float(seq[3][below].abs().max()) > 1e-3
    jw = _jax_wkv_grads(r, kk, v, w, u, state, do, ds)[3]
    f32 = wkv6_bwd_plain(*(torch.from_numpy(x) for x in (r, kk, v, w, u, do, state, ds)))[3]
    np.testing.assert_allclose(f32.numpy(), np.asarray(jw), atol=TOL, rtol=TOL)
    # The chunked backward's twin: its chunk states carry the clamp (an
    # e^-60 effect), its walk forms dw from G_t and S_{t-1} on w itself,
    # so it gives the sequential derivative, below the clamp too.
    chunked = wkv6_bwd_chunked_plain(*ins[:5], d(do), ins[5], d(ds))
    for name, g, want in zip(("dr", "dk", "dv", "dw", "du", "d_state0"), chunked, seq):
        torch.testing.assert_close(g, want, atol=1e-6, rtol=1e-6, msg=name)
    assert float(chunked[3][below].abs().max()) > 1e-3


def test_only_decode_attention_refuses_a_gradient():
    assert set(ops._NO_BACKWARD) == {"decode_attention"}
    counts = ops.launch_counts()
    assert {"wkv6_bwd", "rglru_bwd"} <= set(counts)
    assert {"wkv6_bwd", "rglru_bwd"} <= set(_build.KERNELS)
    for name in ("wkv6_bwd", "rglru_bwd"):
        assert (_build.CSRC / f"{name}.cu").exists()


def _through_plain_pair(monkeypatch):
    """Route ops.wkv6 / ops.rglru_scan (CPU tensors) through the plain
    forward + plain backward Functions: the kernels' structure."""
    def wkv6(r, k, v, w, u, state=None, *, state_out=None, active=None):
        assert state_out is None and active is None
        return _PlainWKV6.apply(r, k, v, w, u, state)

    monkeypatch.setattr(ops, "wkv6", wkv6)
    monkeypatch.setattr(ops, "rglru_scan", lambda a, b, h0=None: _PlainRGLRU.apply(a, b, h0))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_tiny_model_gradients_through_plain_backwards_match_jax(arch, monkeypatch):
    """The slice as a whole: the tiny model's loss and every gradient leaf
    with its recurrences' gradients from the plain backwards, against
    ``jax.value_and_grad`` of the reference's loss (1e-4 of each leaf's
    max abs, as tests/test_torch_training.py holds the autograd path)."""
    _through_plain_pair(monkeypatch)
    jm = jmodel_for(jtiny(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(tiny(arch), remat=True)
    tp = ttl.trainable(interop.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jnp.asarray(tokens))))(jp)
    loss = model_for(cfg).loss(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=0)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    want = dict(leaf_paths(jax.tree.map(np.asarray, jg)))
    names = [n for n, _ in leaf_paths(tp)]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        w = np.asarray(want[name], np.float64)
        err = np.abs(g.double().numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), f"{name}: {err:.3e}"
