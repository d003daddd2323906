"""The port's M-RoPE (qwen2-vl), its position-valued flash mask and the
sinusoidal positions against the JAX package, at tiny sizes on the CPU.

Inputs come from numpy with a seed; parameters come from ``repro``'s own
``model.init`` and reach the port through ``repro_torch.interop``. The
reference runs its default ``impl="xla"``, which masks prefill by the
temporal stream's position values (``positions[0]``): an image's tokens
share one temporal position and attend to each other both ways.
Tolerances: layers and attention 2e-5 in float32 (2e-2 in bf16), model
logits 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as jtiny
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import model_for as jmodel_for
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import model_for

ARCH = "qwen2-vl-72b"
KEY = jax.random.PRNGKey(9)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(
        np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32),
        np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32),
        atol=tol, rtol=tol,
    )


def vl_positions(b, s, prefixes, grid=(2, 3)):
    """Qwen2-VL position ids (3, B, S): text, one image of gh x gw tokens
    at one temporal position (heights and widths on the other streams),
    then text from prefix + max(gh, gw) on all three streams."""
    gh, gw = grid
    n = gh * gw
    pos = np.zeros((3, b, s), np.int32)
    for r, p in enumerate(prefixes):
        pos[:, r, :p] = np.arange(p)
        pos[0, r, p:p + n] = p
        pos[1, r, p:p + n] = p + np.repeat(np.arange(gh), gw)
        pos[2, r, p:p + n] = p + np.tile(np.arange(gw), gh)
        pos[:, r, p + n:] = p + max(gh, gw) + np.arange(s - p - n)
    return pos


@pytest.fixture(scope="module")
def qwen():
    """(JAX model, JAX params, port model, port params, tokens, positions)."""
    jm = jmodel_for(jtiny(ARCH))
    jp = jm.init(KEY)
    tm = model_for(tiny(ARCH))
    tp = interop.params_from_numpy(tiny(ARCH), _np_tree(jp), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, size=(2, 28)).astype(np.int32)
    return jm, jp, tm, tp, toks, vl_positions(2, 20, [3, 7])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,sections", [(16, (2, 1, 1)), (128, (2, 1, 1)), (24, (1, 1, 1)),
                                        (32, (3, 2, 1))])
def test_apply_mrope_matches_jax(d, sections):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    pos = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    _close(tl.apply_mrope(_t(x), _t(pos), 1e6, sections), want, 2e-5)


def test_apply_mrope_on_equal_streams_is_rope():
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((2, 5, 2, 16)).astype(np.float32))
    pos = _t(rng.integers(0, 99, (2, 5)).astype(np.int32))
    _close(tl.apply_mrope(x, pos.expand(3, 2, 5), 1e4), tl.apply_rope(x, pos, 1e4), 1e-6)


@pytest.mark.parametrize("length,dim", [(1, 8), (37, 64), (1500, 1280), (5, 2)])
def test_sinusoidal_positions_matches_jax(length, dim):
    """2e-5, plus the float32 angle's own rounding: t * inv carries about
    t * 2^-23 of absolute error at frequency 1, which the sine passes on
    (1.8e-4 at Whisper's t = 1499)."""
    want = jl.sinusoidal_positions(length, dim)
    got = tl.sinusoidal_positions(length, dim, device="cpu")
    assert got.shape == (length, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5 + length * 2.0 ** -23)


# ---------------------------------------------------------------------------
# the flash kernel's plain version with positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_plain_positions_match_reference_dense(dtype, window):
    """Position-valued causal (and window) masks against the reference's
    dense attention under ``build_mask`` on the same positions: keys that
    share a query's position are attended both ways."""
    rng = np.random.default_rng(7)
    b, s, h, kv, d = 2, 40, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, d)) for n in (h, kv, kv))
    pos = vl_positions(b, s, [0, 11], grid=(3, 4))[0]
    mask = jattn.build_mask(jnp.asarray(pos), jnp.asarray(pos), None, True, window)
    cast = lambda x: jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))
    want = jattn.dense_attention(cast(q), cast(k), cast(v), mask).astype(jnp.float32)
    tq, tk, tv = (_t(np.asarray(x, np.float32)).to(getattr(torch, dtype)) for x in (q, k, v))
    kw = dict(causal=True, window=window, q_pos=_t(pos), kv_pos=_t(pos))
    got = tops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])
    arange = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    assert float((arange.float() - got.float()).abs().max()) > 1e-2


def test_flash_plain_arange_positions_equal_default():
    rng = np.random.default_rng(8)
    q, k, v = (_t(rng.standard_normal((2, 33, n, 8)).astype(np.float32)) for n in (4, 2, 2))
    pos = torch.arange(33, dtype=torch.int32).expand(2, 33)
    for window in (None, 7):
        assert flash_attention_ref(q, k, v, window=window, q_pos=pos, kv_pos=pos).equal(
            flash_attention_ref(q, k, v, window=window))


def test_flash_positions_precondition_checked_in_the_plain_version():
    """The kernel's causal tile skip relies on non-decreasing positions
    with a key at or before every query; the plain version refuses others (the kernel's wrapper cannot check
    without a host sync), and positions come in pairs."""
    q = torch.zeros(1, 4, 2, 8)
    bad = torch.tensor([[0, 2, 1, 3]], dtype=torch.int32)
    good = torch.tensor([[0, 1, 1, 3]], dtype=torch.int32)
    with pytest.raises(ValueError, match="non-decreasing"):
        flash_attention_ref(q, q, q, q_pos=bad, kv_pos=good)
    with pytest.raises(ValueError, match="non-decreasing"):
        flash_attention_ref(q, q, q, q_pos=good, kv_pos=bad)
    with pytest.raises(ValueError, match="at or before"):
        flash_attention_ref(q, q, q, q_pos=good, kv_pos=good + 1)
    with pytest.raises(ValueError, match="together"):
        flash_attention_ref(q, q, q, q_pos=good)
    flash_attention_ref(q, q, q, causal=False, q_pos=bad, kv_pos=bad)  # unread: allowed


# ---------------------------------------------------------------------------
# attention with M-RoPE
# ---------------------------------------------------------------------------


def _attn_params(rng, d=32, h=4, kv=2, hd=16):
    spec = jattn.attention_spec(d, h, kv, hd)
    return {n: (0.3 * rng.standard_normal(p.shape)).astype(np.float32) for n, p in spec.items()}


@pytest.mark.parametrize("impl", ["xla", "dense"])
def test_mha_mrope_matches_jax(impl):
    rng = np.random.default_rng(3)
    p = _attn_params(rng)
    b, s = 2, 20
    x = rng.standard_normal((b, s, 32)).astype(np.float32)
    pos = vl_positions(b, s, [2, 9])
    want = jattn.mha({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                     jnp.asarray(pos), rope_theta=1e6, rope_kind="mrope")
    got = tattn.mha({n: _t(a) for n, a in p.items()}, _t(x), _t(pos), rope_theta=1e6,
                    rope_kind="mrope", impl=impl)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("impl", ["xla", "dense"])
def test_mha_decode_and_project_kv_mrope_match_jax(impl):
    rng = np.random.default_rng(4)
    p = _attn_params(rng)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: _t(a) for n, a in p.items()}
    b, s = 2, 12
    x = rng.standard_normal((b, 1, 32)).astype(np.float32)
    mpos = rng.integers(0, 30, (3, b, 1)).astype(np.int32)
    jk, jv = jattn.project_kv(jp, jnp.asarray(x), jnp.asarray(mpos), 1e6, "mrope")
    tk, tv = tattn.project_kv(tp, _t(x), _t(mpos), 1e6, "mrope")
    _close(tk, jk, 2e-5)
    _close(tv, jv, 2e-5)
    ck = rng.standard_normal((b, s, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((b, s, 2, 16)).astype(np.float32)
    cursor = np.array([11, 6], np.int32)
    kv_pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    valid = kv_pos <= cursor[:, None]
    want = jattn.mha_decode(jp, jnp.asarray(x), jnp.asarray(cursor), jnp.asarray(ck),
                            jnp.asarray(cv), jnp.asarray(kv_pos), jnp.asarray(valid),
                            rope_theta=1e6, rope_kind="mrope", mrope_position=jnp.asarray(mpos))
    got = tattn.mha_decode(tp, _t(x), _t(cursor), _t(ck), _t(cv), _t(kv_pos), _t(valid),
                           rope_theta=1e6, rope_kind="mrope", mrope_position=_t(mpos),
                           impl=impl)
    _close(got, want, 2e-5)


def test_unknown_rope_kind_raises():
    p = {n: _t(a) for n, a in _attn_params(np.random.default_rng(0)).items()}
    with pytest.raises(ValueError, match="rope_kind"):
        tattn.mha(p, torch.zeros(1, 3, 32), torch.zeros(1, 3, dtype=torch.long),
                  rope_kind="yarn")


# ---------------------------------------------------------------------------
# tiny qwen2-vl against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "dense"])
def test_forward_vision_positions_matches_jax(qwen, impl):
    """Forward on Qwen2-VL positions (an image block with tied temporal
    positions) against the reference's xla forward."""
    import dataclasses

    jm, jp, tm, tp, toks, pos = qwen
    s = pos.shape[-1]
    want, _ = jm.forward(jp, jnp.asarray(toks[:, :s]), jnp.asarray(pos))
    m = model_for(dataclasses.replace(tiny(ARCH), impl=impl))
    got, aux = m.forward(tp, _t(toks[:, :s]), _t(pos))
    assert got.shape == (2, s, 256) and float(aux) == 0.0
    _close(got, want, 2e-3)
    text = np.broadcast_to(np.arange(s, dtype=np.int32), (3, 2, s))
    other, _ = m.forward(tp, _t(toks[:, :s]), _t(text))
    assert float((other - got).abs().max()) > 1e-3


def test_prefill_then_decode_matches_jax(qwen):
    """Prefill on the vision positions, then decode steps at the default
    mrope_position (the cursor on all three streams) and the cursor-
    indexed decode mask: the reference's own semantics, against its
    prefill and decode_step."""
    jm, jp, tm, tp, toks, pos = qwen
    b, s = 2, pos.shape[-1]
    jcache = jm.init_cache(b, toks.shape[1])
    tcache = tm.init_cache(b, toks.shape[1], device="cpu")
    jl_, jcache = jm.prefill(jp, jcache, jnp.asarray(toks[:, :s]), jnp.asarray(pos))
    tl_, out = tm.prefill(tp, tcache, _t(toks[:, :s]), _t(pos))
    assert out is tcache
    _close(tl_, jl_, 2e-3)
    for t in range(s, toks.shape[1]):
        cur = np.full((b,), t, np.int32)
        jl_, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]), jnp.asarray(cur))
        tl_, _ = tm.decode_step(tp, tcache, _t(toks[:, t]), _t(cur))
        _close(tl_, jl_, 2e-3)
    # An explicit mrope_position equal to the default gives the same step.
    c2 = tm.init_cache(b, toks.shape[1], device="cpu")
    tm.prefill(tp, c2, _t(toks[:, :s]), _t(pos))
    cur = torch.full((b,), s, dtype=torch.int32)
    a, _ = tm.decode_step(tp, c2, _t(toks[:, s]), cur,
                          mrope_position=cur[None, :, None].expand(3, b, 1))
    c3 = tm.init_cache(b, toks.shape[1], device="cpu")
    tm.prefill(tp, c3, _t(toks[:, :s]), _t(pos))
    assert a.equal(tm.decode_step(tp, c3, _t(toks[:, s]), cur)[0])


def test_forward_without_positions_raises(qwen):
    """The port refuses an M-RoPE forward or prefill without (3, B, S)
    positions. (The reference raises too, by accident: ``ValueError: axis
    2 is out of bounds`` from inside ``apply_mrope``.)"""
    jm, jp, tm, tp, toks, _ = qwen
    with pytest.raises(ValueError):
        jm.forward(jp, jnp.asarray(toks[:, :8]))
    with pytest.raises(ValueError, match="M-RoPE"):
        tm.forward(tp, _t(toks[:, :8]))
    with pytest.raises(ValueError, match="M-RoPE"):
        tm.prefill(tp, tm.init_cache(2, 8, device="cpu"), _t(toks[:, :8]))
    with pytest.raises(ValueError, match=r"\(3, 2, 8\)"):
        tm.forward(tp, _t(toks[:, :8]), torch.zeros(2, 8, dtype=torch.int32))


# ---------------------------------------------------------------------------
# test_arch_smoke twins
# ---------------------------------------------------------------------------


def _text_pos(b, s):
    return torch.arange(s).expand(3, b, s)


def test_arch_smoke_forward_shapes_and_finite():
    cfg = tiny(ARCH)
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    logits, aux = model.forward(params, toks, _text_pos(2, 24))
    assert logits.shape == (2, 24, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


def test_arch_smoke_decode_matches_forward():
    cfg = tiny(ARCH)
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    pos3 = _text_pos(2, 24)
    full, _ = model.forward(params, toks, pos3)
    cache = model.init_cache(2, 24, device="cpu")
    errs = []
    for t in range(24):
        cur = torch.full((2,), t, dtype=torch.int32)
        lg, _ = model.decode_step(params, cache, toks[:, t], cur, pos3[:, :, t:t + 1])
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 5e-3
