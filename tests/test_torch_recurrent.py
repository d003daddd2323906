"""The port's recurrent slice against the JAX package, on the CPU.

Covers the two recurrence kernels' plain versions (``wkv6``, ``rglru``),
``models/recurrent.py``, the ring caches, the ``rwkv``/``rglru``/``swa``
block kinds of the transformer, interop of their parameter trees and the
engine's arena over recurrent and ring caches. Inputs come from numpy
with a seed; model parameters come from ``repro``'s ``model.init`` and
reach the port through ``repro_torch.interop``.

Tolerances are the reference's own: kernels 2e-5 in float32 and 2e-2 in
bfloat16 (``tests/test_kernels.py``), float32 layers 2e-5, model logits
2e-3 (``test_model_pallas_matches_xla``). The Pallas kernels run in
interpret mode through ``repro.kernels.ops``, as that file runs them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as jtiny
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import kvcache as jkv
from repro.models import model_for as jmodel_for
from repro.models import recurrent as jrec
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.kernels import ops as tops
from repro_torch.kernels.rglru import rglru_scan_plain
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models import kvcache as tkv
from repro_torch.models import model_for
from repro_torch.models import recurrent as trec
from repro_torch.serving.engine import InferenceEngine

KEY = jax.random.PRNGKey(3)
# tiny recurrentgemma at 5 layers: one (rglru, rglru, swa) superblock and
# a two-layer unstacked (rglru, rglru) tail, as the full model has.
ARCHS = {"rwkv6-1.6b": {}, "recurrentgemma-9b": {"n_layers": 5}}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WKV_SHAPES = [(1, 8, 2, 8), (2, 90, 2, 16), (1, 200, 4, 64), (2, 33, 8, 32)]
RGLRU_SHAPES = [(1, 8, 16), (2, 90, 48), (1, 256, 128), (3, 37, 520)]


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(
        np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32),
        np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32),
        atol=tol, rtol=tol,
    )


def _pair(arr, name):
    jd, td = DTYPES[name]
    return jnp.asarray(arr).astype(jd), torch.from_numpy(np.ascontiguousarray(arr)).to(td)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# ---------------------------------------------------------------------------
# kernels: plain versions against the oracles and the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_plain_matches_jax(shape, dtype, with_state):
    b, s, h, k = shape
    rng = np.random.default_rng(sum(shape) + 7 * with_state)
    r, kk, v = (rng.standard_normal((b, s, h, k), np.float32) * 0.5 for _ in range(3))
    w = _sigmoid(rng.standard_normal((b, s, h, k))).astype(np.float32) * 0.5 + 0.45
    u = rng.standard_normal((h, k), np.float32) * 0.1
    st0 = rng.standard_normal((b, h, k, k), np.float32) * 0.1 if with_state else None
    jargs = [_pair(x, dtype)[0] for x in (r, kk, v, w)]
    targs = [_pair(x, dtype)[1] for x in (r, kk, v, w)]
    jst = None if st0 is None else jnp.asarray(st0)
    tst = None if st0 is None else _t(st0)
    out, last = tops.wkv6(*targs, _t(u), tst)  # CPU tensors: the plain version
    assert out.dtype == DTYPES[dtype][1] and last.dtype == torch.float32
    for eo, es in (jref.wkv6_ref(*jargs, jnp.asarray(u), jst),
                   jops.wkv6(*jargs, jnp.asarray(u), jst)):  # Pallas, interpret mode
        _close(out, eo, _tol(dtype))
        _close(last, es, _tol(dtype))
    if tst is not None:
        # state_out receives the last state in place, and may be the input.
        buf = tst.clone()
        o2, l2 = tops.wkv6(*targs, _t(u), buf, state_out=buf)
        assert l2 is buf and torch.equal(o2, out) and torch.equal(buf, last)


@pytest.mark.parametrize("shape", RGLRU_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_plain_matches_jax(shape, dtype, with_h0):
    b, s, d = shape
    rng = np.random.default_rng(sum(shape) + 5 * with_h0)
    a = _sigmoid(rng.standard_normal((b, s, d))).astype(np.float32) * 0.5 + 0.45
    x = rng.standard_normal((b, s, d), np.float32) * 0.1
    h0 = rng.standard_normal((b, d), np.float32) if with_h0 else None
    (ja, ta), (jx, tx) = _pair(a, dtype), _pair(x, dtype)
    jh = None if h0 is None else jnp.asarray(h0)
    out, last = tops.rglru_scan(ta, tx, None if h0 is None else _t(h0))
    assert out.dtype == DTYPES[dtype][1] and last.dtype == torch.float32
    for eo, el in (jref.rglru_ref(ja, jx, jh), jops.rglru_scan(ja, jx, jh)):
        _close(out, eo, _tol(dtype))
        _close(last, el, _tol(dtype))


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The wrappers launch only on CUDA tensors; ``ops`` sends a CPU
    tensor to the plain version without touching the launch counters."""
    from repro_torch.kernels import rglru, wkv6

    before = tops.launch_counts()
    assert {"wkv6", "rglru_scan"} <= set(before)
    x = torch.zeros((1, 2, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6.wkv6(x, x, x, x, torch.zeros((1, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        rglru.rglru_scan(torch.zeros((1, 2, 4)), torch.zeros((1, 2, 4)))
    tops.wkv6(x, x, x, x, torch.zeros((1, 4)))
    tops.rglru_scan(torch.zeros((1, 2, 4)), torch.zeros((1, 2, 4)))
    assert tops.launch_counts() == before
    assert wkv6_plain is not None and rglru_scan_plain is not None


# ---------------------------------------------------------------------------
# models/recurrent.py against repro.models.recurrent
# ---------------------------------------------------------------------------


def _spec_params(spec, rng, scale=0.3):
    """Random numpy params for a spec tree (lam kept near its init)."""
    def leaf(p):
        return (rng.standard_normal(p.shape) * scale).astype(np.float32)
    if isinstance(spec, dict):
        return {k: _spec_params(v, rng, scale) for k, v in spec.items()}
    return leaf(spec)


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), jax.tree.map(_t, tree)


def test_griffin_pieces_match_jax():
    rng = np.random.default_rng(11)
    d_model, d_rnn, b, s = 24, 32, 2, 13
    jp, tp = _both(_spec_params(jrec.griffin_block_spec(d_model, d_rnn), rng))
    xr = rng.standard_normal((b, s, d_rnn), np.float32)
    for got, want in zip(trec.rglru_gates(tp["rglru"], _t(xr)),
                         jrec.rglru_gates(jp["rglru"], jnp.asarray(xr))):
        _close(got, want, 2e-5)
    h0 = rng.standard_normal((b, d_rnn), np.float32) * 0.5
    for got, want in zip(trec.rglru_prefill(tp["rglru"], _t(xr), _t(h0)),
                         jrec.rglru_prefill(jp["rglru"], jnp.asarray(xr), jnp.asarray(h0))):
        _close(got, want, 2e-5)
    cs = rng.standard_normal((b, trec.CONV_WIDTH - 1, d_rnn), np.float32)
    x = rng.standard_normal((b, s, d_model), np.float32)
    state = {"h": h0, "conv": cs}
    for impl in ("xla", "pallas", "dense"):
        for st in (None, state):
            jy, js = jrec.griffin_block(jp, jnp.asarray(x), None if st is None else
                                        jax.tree.map(jnp.asarray, st),
                                        impl="xla" if impl == "dense" else impl)
            ty, ts = trec.griffin_block(tp, _t(x), None if st is None else
                                        jax.tree.map(_t, st), impl=impl)
            _close(ty, jy, 2e-5)
            _close(ts["h"], js["h"], 2e-5)
            _close(ts["conv"], js["conv"], 2e-5)
    # Decode is griffin_block on one token with the carried state: the
    # path the transformer serves, against the reference's step.
    jy, js = jrec.griffin_block_step(jp, jnp.asarray(x[:, 0]), jax.tree.map(jnp.asarray, state))
    for impl in ("xla", "dense"):
        ty, ts = trec.griffin_block(tp, _t(x[:, :1]), jax.tree.map(_t, state), impl=impl)
        _close(ty[:, 0], jy, 2e-5)
        _close(ts["h"], js["h"], 2e-5)
        _close(ts["conv"], js["conv"], 2e-5)
    init = trec.griffin_init_state(3, d_rnn, device="cpu", lead=(2,))
    for name, leaf in jrec.griffin_init_state(3, d_rnn).items():
        assert tuple(init[name].shape) == (2,) + leaf.shape and not init[name].any()


def test_rwkv6_pieces_match_jax():
    rng = np.random.default_rng(12)
    d, heads, d_ff, b, s = 32, 4, 48, 2, 11
    jp, tp = _both(_spec_params(jrec.rwkv6_timemix_spec(d, heads), rng))
    x = rng.standard_normal((b, s, d), np.float32)
    xp = rng.standard_normal((b, s, d), np.float32)
    for got, want in zip(trec._rwkv6_inputs(tp, _t(x), _t(xp)),
                         jrec._rwkv6_inputs(jp, jnp.asarray(x), jnp.asarray(xp))):
        _close(got, want, 2e-5)
    hd = d // heads
    r, k, v = (rng.standard_normal((b, s, heads, hd), np.float32) * 0.5 for _ in range(3))
    w = _sigmoid(rng.standard_normal((b, s, heads, hd))).astype(np.float32) * 0.5 + 0.45
    u = rng.standard_normal((heads, hd), np.float32) * 0.1
    st0 = rng.standard_normal((b, heads, hd, hd), np.float32) * 0.1
    got = trec.rwkv6_wkv_scan(*map(_t, (r, k, v, w, u, st0)))
    want = jrec.rwkv6_wkv_scan(*map(jnp.asarray, (r, k, v, w, u, st0)))
    assert got[0].dtype == torch.float32
    for g, e in zip(got, want):
        _close(g, e, 2e-5)
    state = {"shift": rng.standard_normal((b, d), np.float32),
             "wkv": rng.standard_normal((b, heads, hd, hd), np.float32) * 0.1}
    for impl in ("xla", "pallas", "dense"):
        for st in (None, state):
            jy, js = jrec.rwkv6_timemix(jp, jnp.asarray(x), heads, None if st is None else
                                        jax.tree.map(jnp.asarray, st), impl="xla")
            ty, ts = trec.rwkv6_timemix(tp, _t(x), heads, None if st is None else
                                        jax.tree.map(_t, st), impl=impl)
            _close(ty, jy, 2e-5)
            _close(ts["shift"], js["shift"], 2e-5)
            _close(ts["wkv"], js["wkv"], 2e-5)
    # wkv_out takes the new state in place (the decode arena's leaf).
    buf = _t(state["wkv"])
    ty, ts = trec.rwkv6_timemix(tp, _t(x[:, :1]), heads, {"shift": _t(state["shift"]),
                                "wkv": buf}, wkv_out=buf)
    jy, js = jrec.rwkv6_timemix(jp, jnp.asarray(x[:, :1]), heads,
                                jax.tree.map(jnp.asarray, state))
    assert ts["wkv"] is buf
    _close(buf, js["wkv"], 2e-5)
    _close(ty, jy, 2e-5)
    cp = _spec_params(jrec.rwkv6_channelmix_spec(d, d_ff), rng)
    jc, tc = _both(cp)
    for st in (None, state["shift"]):
        got = trec.rwkv6_channelmix(tc, _t(x), None if st is None else _t(st))
        want = jrec.rwkv6_channelmix(jc, jnp.asarray(x), None if st is None else jnp.asarray(st))
        for g, e in zip(got, want):
            _close(g, e, 2e-5)
    # The port keeps the state flat, as its decode arena does.
    init = trec.rwkv6_init_state(3, d, heads, device="cpu", lead=(2,))
    ref = jrec.rwkv6_init_state(3, d, heads)
    want = {"shift": ref["time"]["shift"], "wkv": ref["time"]["wkv"], "channel": ref["channel"]}
    assert list(init) == list(want)
    for name, leaf in want.items():
        assert tuple(init[name].shape) == (2,) + leaf.shape and not init[name].any()


def test_recurrence_impl_is_checked():
    with pytest.raises(ValueError, match="impl"):
        trec.griffin_block({}, torch.zeros((1, 2, 4)), impl="triton")


# ---------------------------------------------------------------------------
# ring caches
# ---------------------------------------------------------------------------


def test_ring_cache_write_views_fill_and_wrap_match_jax():
    rng = np.random.default_rng(13)
    b, window, kv, d = 3, 5, 1, 4
    jc = jkv.ring_cache_init(b, window, kv, d, jnp.float32)
    tc = tkv.ring_cache_init(b, window, kv, d, torch.float32, device="cpu")
    assert tc["pos"].dtype == torch.int32 and bool((tc["pos"] == -1).all())
    # Fill from a prefill longer than the window (wraps), then decode on.
    s = 7
    k = rng.standard_normal((b, s, kv, d), np.float32)
    v = rng.standard_normal((b, s, kv, d), np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    jc = jkv.ring_cache_fill_from_prefill(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    ptrs = {n: t.data_ptr() for n, t in tc.items()}
    assert tkv.ring_cache_fill_from_prefill(tc, _t(k), _t(v), _t(pos)) is tc
    for step in range(6):
        kt = rng.standard_normal((b, 1, kv, d), np.float32)
        vt = rng.standard_normal((b, 1, kv, d), np.float32)
        cur = np.array([s + step, s + 2 * step, 3], np.int32)
        jc = jkv.ring_cache_write(jc, jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(cur))
        assert tkv.ring_cache_write(tc, _t(kt), _t(vt), _t(cur)) is tc
        for got, want in zip(tkv.ring_cache_views(tc, _t(cur)),
                             jkv.ring_cache_views(jc, jnp.asarray(cur))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {n: t.data_ptr() for n, t in tc.items()} == ptrs  # in place
    # A short prefill leaves -1 sentinels in the unwritten slots.
    jc2 = jkv.ring_cache_fill_from_prefill(
        jkv.ring_cache_init(b, window, kv, d, jnp.float32),
        jnp.asarray(k[:, :2]), jnp.asarray(v[:, :2]), jnp.asarray(pos[:, :2]))
    tc2 = tkv.ring_cache_fill_from_prefill(
        tkv.ring_cache_init(b, window, kv, d, torch.float32, device="cpu"),
        _t(k[:, :2]), _t(v[:, :2]), _t(pos[:, :2]))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(tc2[name].numpy(), np.asarray(jc2[name]))
    assert tc2["pos"][0].tolist() == [0, 1, -1, -1, -1]
    assert tkv.cache_nbytes(tc) == jkv.cache_nbytes(jc)


# ---------------------------------------------------------------------------
# interop and the transformer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(ARCHS))
def model_pair(request):
    """(arch, JAX model, JAX params, port model, port params)."""
    arch = request.param
    jm = jmodel_for(jtiny(arch, **ARCHS[arch]))
    jp = jm.init(KEY)
    cfg = tiny(arch, **ARCHS[arch])
    tp = interop.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return arch, jm, jp, model_for(cfg), tp


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interop_round_trip_exact(arch, dtype):
    cfg = jtiny(arch, param_dtype=dtype, **ARCHS[arch])
    tree = jax.tree.map(np.asarray, jmodel_for(cfg).init(KEY))
    params = interop.params_from_numpy(
        tiny(arch, param_dtype=dtype, **ARCHS[arch]), tree, device="cpu")
    if arch == "rwkv6-1.6b":
        n, d, h = cfg.n_super, cfg.d_model, cfg.n_heads
        assert tuple(params["super"][0]["mixer"]["mu"].shape) == (n, 5, d)
        assert tuple(params["super"][0]["mixer"]["bonus_u"].shape) == (n, h, d // h)
    else:
        assert tuple(params["super"][0]["mixer"]["conv"]["w"].shape) == (
            cfg.n_super, 4, cfg.d_rnn)
        assert len(params["tail"]) == 2 and "rglru" in params["tail"][0]["mixer"]
    back = interop.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf, np.float32))


def test_forward_matches_jax(model_pair):
    _, jm, jp, tm, tp = model_pair
    toks = np.random.default_rng(14).integers(0, 256, size=(2, 37)).astype(np.int32)
    jl_, _ = jm.forward(jp, jnp.asarray(toks))
    tl_, _ = tm.forward(tp, _t(toks))
    assert tl_.dtype == torch.float32 and tuple(tl_.shape) == (2, 37, 256)
    _close(tl_, jl_, 2e-3)
    dense = model_for(tiny(model_pair[0], impl="dense", **ARCHS[model_pair[0]]))
    _close(dense.forward(tp, _t(toks))[0], tl_, 2e-3)


def test_prefill_then_decode_past_window_matches_jax(model_pair):
    """Prefill 20 tokens, then 14 decode steps: recurrentgemma's 16-slot
    ring wraps; logits against the JAX model's at every step, and against
    the port's own full forward at the same positions."""
    arch, jm, jp, tm, tp = model_pair
    rng = np.random.default_rng(15)
    b, n_pre, n_dec, max_len = 2, 20, 14, 40
    toks = rng.integers(0, 256, size=(b, n_pre + n_dec)).astype(np.int32)
    full, _ = tm.forward(tp, _t(toks))
    jc = jm.init_cache(b, max_len)
    tc = tm.init_cache(b, max_len, device="cpu")
    ptrs = [t.data_ptr() for e in tc["super"] + tc["tail"] for t in e.values()]
    jlog, jc = jm.prefill(jp, jc, jnp.asarray(toks[:, :n_pre]))
    tlog, tc2 = tm.prefill(tp, tc, _t(toks[:, :n_pre]))
    assert tc2 is tc
    _close(tlog, jlog, 2e-3)
    step = jax.jit(jm.decode_step)
    for t in range(n_dec):
        cur = np.full((b,), n_pre + t, np.int32)
        jlog, jc = step(jp, jc, jnp.asarray(toks[:, n_pre + t]), jnp.asarray(cur))
        tlog, _ = tm.decode_step(tp, tc, _t(toks[:, n_pre + t]), _t(cur))
        _close(tlog, jlog, 2e-3)
        _close(tlog, full[:, n_pre + t], 2e-3)
    # Every state leaf was written in place and agrees with the reference.
    assert [t.data_ptr() for e in tc["super"] + tc["tail"] for t in e.values()] == ptrs
    for part in ("super", "tail"):
        for te, je in zip(tc[part], jc[part]):
            for name, leaf in te.items():
                _close(leaf, np.asarray(je[name]), 2e-3)
    if arch == "recurrentgemma-9b":
        ring = tc["super"][2]["pos"][0, 0]  # the swa layer's ring, row 0
        assert sorted(ring.tolist()) == list(range(n_pre + n_dec - 16, n_pre + n_dec))


def test_swa_kind_serves_gemma3_tiny():
    """Ring caches also carry gemma3's mix of swa and attn layers (the
    shared full-cache views and per-layer ring views in one decode)."""
    arch = "gemma3-12b"
    jm = jmodel_for(jtiny(arch))
    jp = jm.init(KEY)
    tm = model_for(tiny(arch))
    tp = interop.params_from_numpy(tiny(arch), jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(16).integers(0, 256, size=(2, 26)).astype(np.int32)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32, device="cpu")
    jlog, jc = jm.prefill(jp, jc, jnp.asarray(toks[:, :18]))
    tlog, _ = tm.prefill(tp, tc, _t(toks[:, :18]))
    _close(tlog, jlog, 2e-3)
    step = jax.jit(jm.decode_step)
    for t in range(18, 26):
        cur = np.full((2,), t, np.int32)
        jlog, jc = step(jp, jc, jnp.asarray(toks[:, t]), jnp.asarray(cur))
        tlog, _ = tm.decode_step(tp, tc, _t(toks[:, t]), _t(cur))
        _close(tlog, jlog, 2e-3)


# ---------------------------------------------------------------------------
# the engine's arena over recurrent and ring caches
# ---------------------------------------------------------------------------


def test_engine_serves_recurrent_models_like_jax():
    """A tiny rwkv6 and a tiny recurrentgemma in one engine on the CPU,
    with the JAX engine's parameters: prefill tokens, slot-arena decode
    logits and the arena's leaves agree on the rows that never idled.
    Row 1 idles on odd steps: its cursor stays, and so does its recurrent
    state in the port, where the reference advances it on a phantom zero
    token (engine.py, ``step_rows``; ROADMAP.md, "Deliberate
    departures"); so the port's idled row and the never-allocated row 3
    keep the state they had, and are compared with the reference only
    before row 1 first idles."""
    cfgs = {a: tiny(a, **kw) for a, kw in ARCHS.items()}
    jeng = JEngine({a: jtiny(a, **kw) for a, kw in ARCHS.items()}, max_slots=4)
    params = {a: interop.params_from_numpy(cfgs[a], jax.tree.map(np.asarray, jeng.params[a]),
                                           device="cpu") for a in ARCHS}
    teng = InferenceEngine(cfgs, max_slots=4, device="cpu", params=params)
    rng = np.random.default_rng(17)
    seq = 24  # decode arena: recurrentgemma's 16-slot ring is narrower
    for mid in ARCHS:
        no_attn = mid == "rwkv6-1.6b"
        toks = rng.integers(0, 256, size=(3, 16)).astype(np.int32)
        jout = np.asarray(jeng.dispatch(mid, (16,), 3, "prefill", payload=toks).wait())
        tout = teng.dispatch(mid, (16,), 3, "prefill", payload=toks).wait().numpy()
        np.testing.assert_array_equal(tout[:3], jout[:3])

        js = jeng.alloc_slots(mid, seq, 3, start_pos=10)
        ts = teng.alloc_slots(mid, seq, 3, start_pos=10)
        assert js == ts == (0, 1, 2)
        arena = teng.arena(mid, seq)
        ptrs = [t.data_ptr() for e in arena.cache["super"] for t in e.values()]
        rec_leaf = "wkv" if no_attn else "h"
        for step in range(9):
            payload = {s: int(rng.integers(0, 256)) for s in ts}
            rows = None if step % 2 == 0 else [0, 2]
            held = arena.cache["super"][0][rec_leaf][:, 1].clone()
            jl = np.asarray(jeng.dispatch(mid, (seq,), 3, "decode", slots=js,
                                          payload=payload, step_rows=rows).wait())
            tl = teng.dispatch(mid, (seq,), 3, "decode", slots=ts, payload=payload,
                               step_rows=rows).wait()
            live = list(ts) if step == 0 else [0, 2]  # row 1 idles from step 1
            _close(tl.numpy()[live], jl[live], 2e-3)
            if rows is not None:  # the idle row's state is held as it was
                assert torch.equal(arena.cache["super"][0][rec_leaf][:, 1], held)
        np.testing.assert_array_equal(arena.cur.numpy(), np.asarray(jeng.arena(mid, seq).cur))
        assert arena.cur.tolist() == [19, 15, 19, 0]
        jcache = jeng.arena(mid, seq).cache
        for part in ("super", "tail"):
            axis = 1 if part == "super" else 0
            for te, je in zip(arena.cache[part], jcache[part]):
                for name, leaf in te.items():
                    got, want = leaf.float().numpy(), np.asarray(je[name], np.float32)
                    _close(got.take([0, 2], axis), want.take([0, 2], axis), 2e-3)
        # The never-allocated row 3 was never stepped: its state is still 0.
        assert float(arena.cache["super"][0][rec_leaf][:, 3].abs().max()) == 0
        assert [t.data_ptr() for e in arena.cache["super"] for t in e.values()] == ptrs

        # Free row 1 and allocate again: the recycled row is wiped in
        # place (recurrent leaves to 0, ring positions to -1).
        jeng.free_slots(mid, seq, [1])
        teng.free_slots(mid, seq, [1])
        assert teng.alloc_slots(mid, seq, 2) == jeng.alloc_slots(mid, seq, 2) == (1, 3)
        jcache = jeng.arena(mid, seq).cache
        for part in ("super", "tail"):
            axis = 1 if part == "super" else 0
            for te, je in zip(arena.cache[part], jcache[part]):
                for name, leaf in te.items():
                    fill = -1 if name == "pos" else 0
                    for row in (1, 3):
                        got = leaf.select(axis, row)
                        np.testing.assert_array_equal(got.numpy(), np.full(got.shape, fill))
                        np.testing.assert_array_equal(
                            got.numpy(), np.asarray(je[name]).take(row, axis))
        assert arena.allocs == 5 and arena.resets == 5
        assert teng.stats["decode_compiles"] == list(ARCHS).index(mid) + 1
        jeng.free_slots(mid, seq, [0, 1, 2, 3])
        teng.free_slots(mid, seq, [0, 1, 2, 3])


@pytest.mark.parametrize("cursor", [3, 4, 11])
def test_ring_cache_present_window_fills_every_ring(cursor):
    """Every ring of a cache tree holds the positions up to ``cursor``
    that it would keep after writing them in order; -1 only where the
    position would be negative. K and V are untouched."""
    b, window = 2, 5
    stacked = tkv.ring_cache_init(b, window, 1, 4, torch.float32, device="cpu", lead=(3,))
    flat = tkv.ring_cache_init(b, window, 1, 4, torch.float32, device="cpu")
    stacked["k"].fill_(7.0)
    tree = {"super": [stacked, {"h": torch.zeros((3, b, 4))}], "tail": [flat]}
    assert tkv.ring_cache_present_window(tree, cursor) is tree
    want = tkv.ring_cache_init(1, window, 1, 4, torch.float32, device="cpu")
    p = np.arange(cursor + 1, dtype=np.int32)
    k = np.zeros((1, p.size, 1, 4), np.float32)
    tkv.ring_cache_fill_from_prefill(want, _t(k), _t(k), _t(p[None]))
    for ring in (flat["pos"], stacked["pos"].reshape(-1, window)):
        for row in ring:
            assert row.tolist() == want["pos"][0].tolist()
    assert bool((stacked["k"] == 7.0).all()) and not tree["super"][1]["h"].any()


def test_prefix_decode_presents_full_rings():
    """Prefix-mode decode (the profiler's workload, synthetic cursors at
    seq-1) sees recurrentgemma's rings full, as a served row at that
    cursor does, not one written slot: the step does a full window's
    attention. Allocating rows wipes them back to -1, and the next
    prefix-mode step presents the rings again."""
    mid = "recurrentgemma-9b"
    cfg = tiny(mid, **ARCHS[mid])
    eng = InferenceEngine({mid: cfg}, max_slots=4, device="cpu")
    seq = 24  # the tiny model's ring has 16 slots
    window = min(cfg.sliding_window, seq)
    want = sorted(range(seq - window, seq))
    arena = eng.arena(mid, seq)
    rings = [e["pos"] for e in arena.cache["super"] if "pos" in e]
    assert rings and all(bool((r == -1).all()) for r in rings)
    logits = eng.dispatch(mid, (seq,), 2, "decode").wait()
    assert logits.shape[:1] == (4,) and bool(torch.isfinite(logits).all())
    for ring in rings:
        for row in ring.reshape(-1, window):
            assert sorted(row.tolist()) == want
    slots = eng.alloc_slots(mid, seq, 2)
    for ring in rings:
        assert bool((ring[:, list(slots)] == -1).all())
    eng.free_slots(mid, seq, slots)
    eng.dispatch(mid, (seq,), 3, "decode").wait()
    for ring in rings:
        for row in ring.reshape(-1, window):
            assert sorted(row.tolist()) == want
