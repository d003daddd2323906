"""The RG-LRU kernels' chunked route, on the CPU: its plain twins and
its route rule.

``ref.rglru_chunked_plain`` and ``ref.rglru_bwd_chunked_plain`` repeat
the chunked kernels' association (per chunk the product of its decays
and its end state from zero, the carries between chunks, each chunk's
walk from its carry; the backward on time reversed) in plain PyTorch.
They are held in float32 at 2e-5 (bf16 at 2e-2) against the JAX
package: ``repro.kernels.ref.rglru_ref``, the Pallas ``rglru_scan`` in
interpret mode (``repro.kernels.ops``), and ``jax.grad`` of
``rglru_ref`` and of ``repro.models.recurrent.rglru_prefill`` (its
associative scan and h0 fold); against the port's sequential twins at
2e-5; and against autograd in float64. Cases: S in {1, 63, 64, 65, 130,
1000}, a ragged D = 520 (at S = 130), h0 and ``dh_last`` present and
absent, decays near 0 (products that underflow through the denormals)
and near 1.
Decays a hair below 1 forget nothing over a thousand steps, and there
the float32 sequential walk itself departs from the exact answer by
more than 2e-5: those are held against the walk in float64, no further
from it than the float32 sequential walk. The route rule and the chunk
planner (``rglru.uses_chunked``, ``rglru.plan_chunks``) are pure
functions, checked here without a card. Inputs come from numpy with a
seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import recurrent as jrec
from repro_torch.kernels import rglru as rk
from repro_torch.kernels.ref import (
    rglru_bwd_chunked_plain,
    rglru_bwd_plain,
    rglru_chunked_plain,
    rglru_ref,
)
from repro_torch.models import recurrent as trec

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SEQS = [1, 63, 64, 65, 130, 1000]
H100_SMS = 132

DECAYS = {
    "typical": lambda rng, shape: rng.uniform(0.5, 0.999, shape),
    "near0": lambda rng, shape: rng.uniform(0.0, 1e-3, shape),  # P underflows in a chunk
    "near1": lambda rng, shape: rng.uniform(0.99, 1.0, shape),
}


def _inputs(b, s, d, with_h0, decay="typical", seed=0):
    """a, b, h0, dh, dh_last as float32 numpy."""
    rng = np.random.default_rng(seed + 7 * s + d + with_h0)
    a = DECAYS[decay](rng, (b, s, d)).astype(np.float32)
    x = (0.1 * rng.standard_normal((b, s, d))).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((b, s, d)).astype(np.float32)
    dlast = rng.standard_normal((b, d)).astype(np.float32)
    return a, x, h0, dh, dlast


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=name)


def _departure(got, want64):
    """max |got - want| / (1 + |want|) against a float64 answer."""
    return float(((got.double() - want64).abs() / (1 + want64.abs())).max())


# ---------------------------------------------------------------------------
# The forward twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,d,decay", [(s, 40, decay) for s in SEQS
                                        for decay in ("typical", "near0", "near1")]
                         + [(130, 520, "typical")])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_chunked_plain_matches_jax(s, d, decay, with_h0):
    """Against the reference's sequential oracle and (typical decays) its
    Pallas kernel in interpret mode, for two chunk lengths the planner
    picks from."""
    a, x, h0, _, _ = _inputs(2, s, d, with_h0, decay)
    jh0 = None if h0 is None else jnp.asarray(h0)
    oracles = [("rglru_ref", jref.rglru_ref(jnp.asarray(a), jnp.asarray(x), jh0))]
    if decay == "typical":
        oracles.append(("pallas", jops.rglru_scan(jnp.asarray(a), jnp.asarray(x), jh0)))
    for chunk in (16, 64):
        out, last = rglru_chunked_plain(_t(a), _t(x), _t(h0), chunk)
        assert out.dtype == torch.float32 and last.dtype == torch.float32
        assert torch.equal(last, out[:, -1])
        for label, (eo, el) in oracles:
            _close(out, eo, TOL["float32"], f"{label} h, chunk {chunk}")
            _close(last, el, TOL["float32"], f"{label} last, chunk {chunk}")


@pytest.mark.parametrize("s", [65, 1000])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_chunked_plain_bf16_matches_jax(s, with_h0):
    a, x, h0, _, _ = _inputs(2, s, 40, with_h0, seed=11)
    ja, jx = (jnp.asarray(v).astype(jnp.bfloat16) for v in (a, x))
    want, want_last = jref.rglru_ref(ja, jx, None if h0 is None else jnp.asarray(h0))
    out, last = rglru_chunked_plain(_t(a, torch.bfloat16), _t(x, torch.bfloat16), _t(h0), 64)
    assert out.dtype == torch.bfloat16 and last.dtype == torch.float32
    _close(out.float(), np.asarray(want.astype(jnp.float32)), TOL["bfloat16"], "h")
    _close(last, want_last, TOL["bfloat16"], "last")


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_rglru_chunked_plain_matches_sequential_twin(s, chunk):
    """Only the carries round apart from the sequential walk; a single
    chunk is the walk itself, bit for bit."""
    a, x, h0, _, _ = _inputs(3, s, 24, True, seed=3)
    seq, seq_last = rglru_ref(_t(a), _t(x), _t(h0))
    out, last = rglru_chunked_plain(_t(a), _t(x), _t(h0), chunk)
    if s <= chunk:
        assert torch.equal(out, seq) and torch.equal(last, seq_last)
    torch.testing.assert_close(out, seq, atol=TOL["float32"], rtol=TOL["float32"])
    torch.testing.assert_close(last, seq_last, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_chunked_plain_float64_is_the_recurrence(with_h0):
    a, x, h0, _, _ = _inputs(2, 130, 40, with_h0, seed=5)
    d = lambda v: None if v is None else torch.from_numpy(v).double()  # noqa: E731
    out, last = rglru_chunked_plain(d(a), d(x), d(h0), 16)
    want, want_last = rglru_ref(d(a), d(x), d(h0))
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, want, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(last, want_last, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("s", [130, 1000])
def test_rglru_chunked_plain_a_hair_below_one_against_float64(s):
    """Decays of 1 - 1e-6 u: the state is a running sum over all of S.
    The chunked association is within 2e-5 of the walk in float64 and no
    further from it than the float32 sequential walk (which, at S = 4096,
    departs by about 2e-4: the reason these are not held to it)."""
    rng = np.random.default_rng(s)
    a = (1 - 1e-6 * rng.uniform(0, 1, (1, s, 256))).astype(np.float32)
    x = (0.1 * rng.standard_normal((1, s, 256))).astype(np.float32)
    h0 = rng.standard_normal((1, 256)).astype(np.float32)
    want = rglru_ref(*(torch.from_numpy(v).double() for v in (a, x, h0)))[0]
    seq = rglru_ref(_t(a), _t(x), _t(h0))[0]
    for chunk in (16, 64):
        dep = _departure(rglru_chunked_plain(_t(a), _t(x), _t(h0), chunk)[0], want)
        assert dep <= TOL["float32"] and dep <= _departure(seq, want) + TOL["float32"], chunk


def test_rglru_chunked_plain_underflowing_decays_are_exact_zeros():
    """Decays of 1e-20: a chunk's product reaches the denormals at its
    second step and 0 at its third; the carry's weight vanishes, and every
    h is b itself after the first step, as the sequential walk has it."""
    a = np.full((1, 100, 8), 1e-20, np.float32)
    x = np.random.default_rng(0).standard_normal((1, 100, 8)).astype(np.float32)
    h0 = np.ones((1, 8), np.float32)
    out, _ = rglru_chunked_plain(_t(a), _t(x), _t(h0), 16)
    seq, _ = rglru_ref(_t(a), _t(x), _t(h0))
    assert torch.equal(out, seq)
    torch.testing.assert_close(out[:, 1:], _t(x)[:, 1:], atol=1e-18, rtol=0)


# ---------------------------------------------------------------------------
# The backward twin
# ---------------------------------------------------------------------------
def _jax_grads(a, x, h0, dh, dlast):
    args = [jnp.asarray(a), jnp.asarray(x)] + ([jnp.asarray(h0)] if h0 is not None else [])

    def f(*xs):
        hs, last = jref.rglru_ref(*xs)
        return jnp.sum(hs * dh) + (0.0 if dlast is None else jnp.sum(last * dlast))

    return jax.grad(f, argnums=tuple(range(len(args))))(*args)


@pytest.mark.parametrize("s,d,decay", [(s, 24, "typical") for s in SEQS]
                         + [(130, 24, "near0"), (1000, 24, "near0"), (130, 520, "typical")])
@pytest.mark.parametrize("states", [False, True])
def test_rglru_bwd_chunked_plain_matches_jax_grad_of_rglru_ref(s, d, decay, states):
    """h0 and ``dh_last`` both absent or both present."""
    a, x, h0, dh, dlast = _inputs(2, s, d, states, decay, seed=1)
    dlast = dlast if states else None
    want = _jax_grads(a, x, h0, dh, dlast)
    h, _ = rglru_ref(_t(a), _t(x), _t(h0))
    for chunk in (16, 64):
        got = rglru_bwd_chunked_plain(_t(a), h, _t(dh), _t(dlast), _t(h0), chunk)
        assert all(g.dtype == torch.float32 for g in got)
        for name, g, w in zip(("da", "db", "dh0"), got, want):
            _close(g, w, TOL["float32"], f"{name}, chunk {chunk}")


@pytest.mark.parametrize("s", [65, 1000])
@pytest.mark.parametrize("chunk", [16, 64])
def test_rglru_bwd_chunked_plain_near_one_against_float64(s, chunk):
    """Decays in [0.99, 1): the gradient accumulates over hundreds of
    steps, and at S = 1000 the float32 sequential backward departs from the
    float64 one by more than 2e-5 of the tolerance's form (tol + tol |g|)
    near g's zero crossings. So the oracle is the backward in float64 on
    the same h (``rglru_bwd_plain`` in float64, itself held against
    autograd in float64 in ``test_torch_recurrent_backward.py``): the
    chunked twin no further from it than the float32 sequential backward,
    within 2e-5."""
    a, x, h0, dh, dlast = _inputs(1, s, 64, True, "near1", seed=2)
    h, _ = rglru_ref(_t(a), _t(x), _t(h0))
    args = (_t(a), h, _t(dh), _t(dlast), _t(h0))
    want = rglru_bwd_plain(*(v.double() for v in args))
    got = rglru_bwd_chunked_plain(*args, chunk=chunk)
    seq = rglru_bwd_plain(*args)
    for name, g, sq, w in zip(("da", "db", "dh0"), got, seq, want):
        assert _departure(g, w) <= _departure(sq, w) + TOL["float32"], name


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("chunk", [16, 64])
def test_rglru_bwd_chunked_plain_matches_sequential_twin(s, chunk):
    a, x, h0, dh, dlast = _inputs(3, s, 24, True, seed=4)
    h, _ = rglru_ref(_t(a), _t(x), _t(h0))
    args = (_t(a), h, _t(dh), _t(dlast), _t(h0))
    got = rglru_bwd_chunked_plain(*args, chunk=chunk)
    seq = rglru_bwd_plain(*args)
    for name, g, sq in zip(("da", "db", "dh0"), got, seq):
        if s <= chunk:
            assert torch.equal(g, sq), name
        torch.testing.assert_close(g, sq, atol=TOL["float32"], rtol=TOL["float32"], msg=name)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_chunked_plain_matches_autograd_float64(with_h0):
    a, x, h0, dh, dlast = _inputs(3, 130, 11, with_h0, seed=6)
    d = lambda v: None if v is None else torch.from_numpy(v).double()  # noqa: E731
    leaves = [d(v).requires_grad_() for v in (a, x)] + ([d(h0).requires_grad_()] if with_h0
                                                        else [])
    hs, last = rglru_ref(*leaves)
    want = torch.autograd.grad((hs * d(dh)).sum() + (last * d(dlast)).sum(), leaves)
    got = rglru_bwd_chunked_plain(d(a), hs.detach(), d(dh), d(dlast), d(h0), chunk=16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_chunked_plain_bf16_matches_jax_grad(with_h0):
    """bf16 a, h and dh as the kernel reads them; the gradients in bf16."""
    a, x, h0, dh, dlast = _inputs(2, 200, 40, with_h0, seed=8)
    bf = lambda v: jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
    a, x, dh = (np.array(bf(v)) for v in (a, x, dh))
    want = _jax_grads(a, x, h0, dh, dlast)
    h, _ = rglru_ref(_t(a, torch.bfloat16), _t(x, torch.bfloat16), _t(h0))
    got = rglru_bwd_chunked_plain(_t(a, torch.bfloat16), h, _t(dh, torch.bfloat16),
                                  _t(dlast), _t(h0), chunk=64)
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.float32
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        _close(g.float(), w, TOL["bfloat16"], name)


class _ChunkedRGLRU(torch.autograd.Function):
    """The chunked twins as one differentiable op (the kernels' structure
    on the CPU)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, last = rglru_chunked_plain(a, b, h0, 16)
        ctx.save_for_backward(a, h, h0)
        return h, last

    @staticmethod
    def backward(ctx, dh, dlast):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_bwd_chunked_plain(a, h, dh, dlast, h0, chunk=16)
        return da, db, None if h0 is None else dh0


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_chunked_through_gates_matches_jax_grad_of_rglru_prefill(with_h0):
    """The whole RG-LRU layer: the reference folds h0 into b_1 and runs an
    associative scan; the port's gates feed the chunked twins."""
    rng = np.random.default_rng(17 + with_h0)
    b, s, d = 2, 65, 16
    p = {"w_a": 0.3 * rng.standard_normal((d, d)), "b_a": 0.1 * rng.standard_normal(d),
         "w_x": 0.3 * rng.standard_normal((d, d)), "b_x": 0.1 * rng.standard_normal(d),
         "lam": 1.0 + 0.3 * rng.standard_normal(d)}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((b, s, d)).astype(np.float32)
    dlast = rng.standard_normal((b, d)).astype(np.float32)

    def f(jp, jx, jh0):
        hs, last = jrec.rglru_prefill(jp, jx, jh0)
        return jnp.sum(hs * dh) + jnp.sum(last * dlast)

    jp = {n: jnp.asarray(v) for n, v in p.items()}
    argnums = (0, 1, 2) if with_h0 else (0, 1)
    want = jax.grad(f, argnums=argnums)(jp, jnp.asarray(x),
                                        None if h0 is None else jnp.asarray(h0))
    want_h, want_last = jrec.rglru_prefill(jp, jnp.asarray(x),
                                           None if h0 is None else jnp.asarray(h0))

    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    a, bb = trec.rglru_gates(tp, tx)
    hs, last = _ChunkedRGLRU.apply(a, bb, th0)
    _close(hs.detach(), want_h, TOL["float32"], "h")
    _close(last.detach(), want_last, TOL["float32"], "last")
    loss = (hs * torch.from_numpy(dh)).sum() + (last * torch.from_numpy(dlast)).sum()
    leaves = [tp[n] for n in sorted(p)] + [tx] + ([th0] if with_h0 else [])
    got = torch.autograd.grad(loss, leaves)
    want_flat = [want[0][n] for n in sorted(p)] + list(want[1:])
    for name, g, w in zip(sorted(p) + ["x", "h0"], got, want_flat):
        _close(g, w, TOL["float32"], name)


# ---------------------------------------------------------------------------
# The route rule and the chunk planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("s", [1, 8, 17, 63, 64, 65, 512, 1000, 4096, 32768])
@pytest.mark.parametrize("d", [16, 520, 2560, 4096])
def test_plan_chunks_covers_every_step_once(b, s, d):
    chunk, n = rk.plan_chunks(b, s, d, H100_SMS)
    assert chunk in rk.CHUNKS and chunk % 8 == 0  # kUnroll in the sources
    assert n == -(-s // chunk)
    # The forward's chunks [c L, min((c + 1) L, S)) and the backward's walk
    # chunks (S-1-kL down to max(S-(k+1)L, 0)) each cover 0 .. S-1 once.
    fwd = [t for c in range(n) for t in range(c * chunk, min((c + 1) * chunk, s))]
    bwd = [t for k in range(n) for t in range(s - 1 - k * chunk, max(s - (k + 1) * chunk, 0) - 1,
                                                -1)]
    assert fwd == list(range(s)) and sorted(bwd) == list(range(s))
    assert rk.plan_chunks(b, s, d, H100_SMS) == (chunk, n)  # a pure function
    if rk.uses_chunked(b, s, d, H100_SMS):
        assert n >= 2 and chunk < s
        assert -(-d // rk.TILE) * b < H100_SMS


def test_route_rule_at_recurrentgemmas_shapes():
    """The served prefill (B 8, S 512, D 4096) and decode (S 1) stream;
    the train step (B 1, S 4096) and batch-1 prefill are chunked, with
    the training shape's 1024 blocks."""
    d = 4096
    assert not rk.uses_chunked(8, 512, d, H100_SMS)
    assert not rk.uses_chunked(8, 1, d, H100_SMS)
    assert not rk.uses_chunked(1, 1, d, H100_SMS)
    assert rk.uses_chunked(1, 4096, d, H100_SMS)
    assert rk.plan_chunks(1, 4096, d, H100_SMS) == (128, 32)
    assert rk.uses_chunked(1, 512, d, H100_SMS)
    chunk, n = rk.plan_chunks(1, 512, d, H100_SMS)
    assert (d // rk.TILE) * n >= rk.BLOCKS_PER_SM * H100_SMS or chunk == min(rk.CHUNKS)


def test_route_refuses_cpu_tensors():
    from repro_torch.kernels import rglru_bwd as rb

    a = torch.zeros((1, 100, 8))
    for fn in (lambda: rk.route(a), lambda: rk.rglru_scan(a, a),
               lambda: rk.previous_design(a, a), lambda: rb.rglru_bwd(a, a, a),
               lambda: rb.previous_design(a, a, a)):
        with pytest.raises(ValueError, match="CUDA"):
            fn()
    assert rk.launches == 0 and rb.launches == 0
