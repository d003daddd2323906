"""The port's encoder-decoder model (whisper), cross-attention and the
non-causal decode mask against the JAX package, at tiny sizes on the CPU.

Inputs come from numpy with a seed; parameters come from ``repro``'s own
``model.init`` and reach the port through ``repro_torch.interop``. The
reference runs its default ``impl="xla"``. Tolerances: attention in
float32 2e-5 and bf16 2e-2 (``tests/test_kernels.py``), model logits 2e-3.

The reference's ``impl="pallas"`` path is not an oracle for whisper: its
decode kernel is never told ``causal=False`` and its flash kernel pads K/V
to the query's length (``repro/models/attention.py:375-381``,
``repro/kernels/flash_attention.py:128-136``);
``test_reference_pallas_path_departs_from_xla`` records the gap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as jtiny
from repro.models import attention as jattn
from repro.models import model_for as jmodel_for
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import (
    decode_attention_ref,
    decode_attention_split_plain,
    flash_attention_ref,
)
from repro_torch.models import EncDecTransformer, model_for
from repro_torch.models import attention as tattn

ARCH = "whisper-large-v3"
KEY = jax.random.PRNGKey(5)
T_ENC = 16
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


def _cast(x, dtype):
    return jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))


def _tcast(x, dtype):
    return _t(np.asarray(x, np.float32)).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def whisper():
    """(JAX model, JAX params, port model, port params, frames, tokens)."""
    jm = jmodel_for(jtiny(ARCH))
    jp = jm.init(KEY)
    tm = model_for(tiny(ARCH))
    tp = interop.params_from_numpy(tiny(ARCH), _np_tree(jp), device="cpu")
    rng = np.random.default_rng(0)
    frames = (0.1 * rng.standard_normal((2, T_ENC, 64))).astype(np.float32)
    toks = rng.integers(0, 256, size=(2, 24)).astype(np.int32)
    return jm, jp, tm, tp, frames, toks


# ---------------------------------------------------------------------------
# the non-causal decode mask (the repaired fault) and cross-attention
# ---------------------------------------------------------------------------


def _attn_params(rng, d=32, h=4, kv=4, hd=8):
    spec = jattn.attention_spec(d, h, kv, hd, bias=True)
    return {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in spec.items()}


@pytest.mark.parametrize("impl", ["xla", "dense"])
@pytest.mark.parametrize("dead_row", [False, True])
def test_mha_decode_causal_false_matches_jax(impl, dead_row):
    """Cross-attention decode: every encoder frame attends whatever the
    cursor. The port's kernel path used to drop ``causal`` and mask
    frames past the cursor."""
    rng = np.random.default_rng(1)
    p = _attn_params(rng)
    b, s = 3, 40
    x = rng.standard_normal((b, 1, 32)).astype(np.float32)
    ck = rng.standard_normal((b, s, 4, 8)).astype(np.float32)
    cv = rng.standard_normal((b, s, 4, 8)).astype(np.float32)
    cursor = np.array([0, 5, 17], np.int32)  # below S: causal would cut frames
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    valid = np.ones((b, s), bool)
    active = np.array([True, not dead_row, True])
    valid = valid & active[:, None]
    want = jattn.mha_decode({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                            jnp.asarray(cursor), jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(pos), jnp.asarray(valid), causal=False,
                            rope_theta=None, rope_kind="none")
    got = tattn.mha_decode({k: _t(v) for k, v in p.items()}, _t(x), _t(cursor), _t(ck),
                           _t(cv), _t(pos), _t(valid), causal=False, rope_theta=None,
                           rope_kind="none", impl=impl, active=_t(active))
    live = active
    _close(got[live], np.asarray(want)[live], 2e-5)
    causal = tattn.mha_decode({k: _t(v) for k, v in p.items()}, _t(x), _t(cursor), _t(ck),
                              _t(cv), _t(pos), _t(valid), rope_theta=None, rope_kind="none",
                              impl=impl, active=_t(active))
    assert float((causal[live] - got[live]).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split", [1, 3])
def test_decode_plain_causal_false_matches_reference_dense(dtype, n_split):
    """The decode kernel's plain version and its split twin with
    ``causal=False`` against the reference's dense path under the same
    mask (validity and ``active`` only), a dead row exact 0."""
    rng = np.random.default_rng(2)
    b, s, kv, g, d = 3, 200, 2, 1, 16
    q = rng.standard_normal((b, 1, kv * g, d))
    ck = rng.standard_normal((b, s, kv, d))
    cv = rng.standard_normal((b, s, kv, d))
    cursor = np.array([3, 0, 100], np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    valid = rng.random((b, s)) > 0.1
    active = np.array([True, True, False])
    mask = jattn.build_mask(jnp.asarray(cursor)[:, None], jnp.asarray(pos),
                            jnp.asarray(valid & active[:, None]), False, None)
    want = jattn.dense_attention(_cast(q, dtype), _cast(ck, dtype), _cast(cv, dtype), mask)
    args = (_tcast(q, dtype), _tcast(ck, dtype), _tcast(cv, dtype), _t(cursor), _t(pos),
            _t(valid), _t(active))
    got = decode_attention_ref(*args, causal=False)
    split = decode_attention_split_plain(*args, causal=False, n_split=n_split)
    for out in (got, split):
        _close(out[:2], np.asarray(want.astype(jnp.float32))[:2], TOL[dtype])
        assert float(out[2].float().abs().max()) == 0.0
    assert tops.decode_attention(*args, causal=False).equal(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,skv", [(1, 37), (24, 16), (33, 150)])
def test_flash_plain_cross_matches_reference(dtype, s, skv):
    """The flash kernel's plain version with ``S_kv != S`` (non-causal)
    against the reference's dense attention and its blocked xla path."""
    rng = np.random.default_rng(s + skv)
    b, h, kv, d = 2, 4, 2, 16
    q = rng.standard_normal((b, s, h, d))
    k = rng.standard_normal((b, skv, kv, d))
    v = rng.standard_normal((b, skv, kv, d))
    qp = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    kp = jnp.broadcast_to(jnp.arange(skv)[None], (b, skv))
    mask = jattn.build_mask(qp, kp, None, False, None)
    want = jattn.dense_attention(_cast(q, dtype), _cast(k, dtype), _cast(v, dtype), mask)
    blocked = jattn.flash_attention_xla(_cast(q, dtype), _cast(k, dtype), _cast(v, dtype), qp,
                                        kp, causal=False, kv_chunk=8)
    got = tops.flash_attention(_tcast(q, dtype), _tcast(k, dtype), _tcast(v, dtype),
                               causal=False)
    assert got.equal(flash_attention_ref(_tcast(q, dtype), _tcast(k, dtype), _tcast(v, dtype),
                                         causal=False))
    _close(got, np.asarray(want.astype(jnp.float32)), TOL[dtype])
    _close(got, np.asarray(blocked.astype(jnp.float32)), TOL[dtype])


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False, window=4)])
def test_flash_cross_refuses_masks(kw):
    """``S_kv != S`` is non-causal and windowless only, in the plain
    version and in the kernel's wrapper alike."""
    q, k = torch.zeros(1, 4, 2, 8), torch.zeros(1, 6, 2, 8)
    with pytest.raises(ValueError, match="S_kv"):
        flash_attention_ref(q, k, k, **kw)
    from repro_torch.kernels import flash_attention as fk

    with pytest.raises(ValueError):  # a CPU tensor never reaches the kernel
        fk.flash_attention(q, k, k, **kw)


@pytest.mark.parametrize("impl", ["xla", "dense"])
def test_mha_kv_override_matches_jax(impl):
    """Cross-attention over a full sequence: the reference's xla ``mha``
    with ``kv_override`` (no causal mask, no rope on K) against the port's
    kernel path (plain on the CPU) and dense path."""
    rng = np.random.default_rng(3)
    p = _attn_params(rng)
    b, s, skv = 2, 9, 21
    x = rng.standard_normal((b, s, 32)).astype(np.float32)
    k = rng.standard_normal((b, skv, 4, 8)).astype(np.float32)
    v = rng.standard_normal((b, skv, 4, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = jattn.mha({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                     jnp.asarray(pos), causal=True, rope_theta=None, rope_kind="none",
                     kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got = tattn.mha({n: _t(a) for n, a in p.items()}, _t(x), _t(pos), causal=True,
                    rope_theta=None, rope_kind="none", impl=impl, kv_override=(_t(k), _t(v)))
    _close(got, want, 2e-5)


# ---------------------------------------------------------------------------
# tiny whisper against the reference
# ---------------------------------------------------------------------------


def test_model_for_builds_encdec_and_interop_round_trips(whisper):
    jm, jp, tm, tp, *_ = whisper
    assert isinstance(tm, EncDecTransformer)
    assert tp["decoder"]["cross_attn"]["wq"].shape == jp["decoder"]["cross_attn"]["wq"].shape
    back = interop.params_to_numpy(tp)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        np.testing.assert_array_equal(flat[path], np.asarray(leaf))
    with pytest.raises(ValueError, match="expected keys"):
        interop.params_from_numpy(tiny(ARCH), {"embed": back["embed"]}, device="cpu")


def test_encode_matches_jax(whisper):
    jm, jp, tm, tp, frames, _ = whisper
    want = jm.encode(jp, jnp.asarray(frames))
    got = tm.encode(tp, _t(frames))
    _close(got, want, 2e-3)


def test_forward_and_loss_match_jax(whisper):
    jm, jp, tm, tp, frames, toks = whisper
    want, _ = jm.forward(jp, jnp.asarray(frames), jnp.asarray(toks))
    got, aux = tm.forward(tp, _t(frames), _t(toks))
    assert got.shape == (2, 24, 256) and got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, 2e-3)
    _close(tm.loss(tp, _t(frames), _t(toks)), jm.loss(jp, jnp.asarray(frames),
                                                       jnp.asarray(toks)), 2e-3)


def test_decode_loop_with_a_dead_row_matches_jax(whisper):
    """encode_for_decode, then decode steps against the self and cross
    caches with row 1 dead: live rows match the reference's decode (and
    both match the forward); the port's self cache is written in place."""
    jm, jp, tm, tp, frames, toks = whisper
    b, s = toks.shape
    active = np.array([True, False])
    jcache = jm.encode_for_decode(jp, jnp.asarray(frames), jm.init_cache(b, s, T_ENC))
    tcache = tm.init_cache(b, s, T_ENC, device="cpu")
    assert tm.encode_for_decode(tp, _t(frames), tcache) is tcache
    _close(tcache["cross_k"], jcache["cross_k"], 2e-3)
    _close(tcache["cross_v"], jcache["cross_v"], 2e-3)
    self_k = tcache["self_k"]
    full, _ = jm.forward(jp, jnp.asarray(frames), jnp.asarray(toks))
    for t in range(s):
        cur = np.full((b,), t, np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]), jnp.asarray(cur),
                                    active=jnp.asarray(active))
        tl, out = tm.decode_step(tp, tcache, _t(toks[:, t]), _t(cur), active=_t(active))
        assert out is tcache and tcache["self_k"] is self_k
        _close(tl[active], np.asarray(jl)[active], 2e-3)
        _close(tl[active], np.asarray(full)[active, t], 2e-3)


def test_reference_pallas_path_departs_from_xla(whisper):
    """Recorded reference behaviour, not ground truth: on tiny whisper the
    reference's impl="pallas" forward and decode differ from its default
    xla path (its kernels drop ``causal=False`` and assume S_kv == S); the
    port holds the xla semantics."""
    jm, jp, tm, tp, frames, toks = whisper
    jp_m = jmodel_for(jtiny(ARCH, impl="pallas"))
    xla, _ = jm.forward(jp, jnp.asarray(frames), jnp.asarray(toks))
    pallas, _ = jp_m.forward(jp, jnp.asarray(frames), jnp.asarray(toks))
    # Here (S_kv = 16 frames < S = 24 tokens) the pallas forward is not
    # even finite; where S_kv >= S it is finite and off by far more than
    # 2e-3.
    assert not bool(jnp.all(jnp.abs(pallas - xla) <= 2e-3))
    b = toks.shape[0]
    caches = [m.encode_for_decode(jp, jnp.asarray(frames), m.init_cache(b, 8, T_ENC))
              for m in (jm, jp_m)]
    cur = jnp.zeros((b,), jnp.int32)
    lx, _ = jm.decode_step(jp, caches[0], jnp.asarray(toks[:, 0]), cur)
    lp, _ = jp_m.decode_step(jp, caches[1], jnp.asarray(toks[:, 0]), cur)
    assert not bool(jnp.all(jnp.abs(lp - lx) <= 2e-3))
    got, _ = tm.forward(tp, _t(frames), _t(toks))
    _close(got, xla, 2e-3)


@pytest.mark.parametrize("impl", ["xla", "dense"])
def test_dense_and_kernel_paths_agree(whisper, impl):
    jm, jp, tm, tp, frames, toks = whisper
    m = model_for(dataclasses.replace(tiny(ARCH), impl=impl))
    want, _ = jm.forward(jp, jnp.asarray(frames), jnp.asarray(toks))
    _close(m.forward(tp, _t(frames), _t(toks))[0], want, 2e-3)


# ---------------------------------------------------------------------------
# test_arch_smoke twins
# ---------------------------------------------------------------------------


def test_arch_smoke_forward_shapes_and_finite():
    cfg = tiny(ARCH)
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    frames = 0.1 * torch.randn(2, T_ENC, cfg.d_model, generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(2))
    logits, aux = model.forward(params, frames, toks)
    assert logits.shape == (2, 24, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert float(model.loss(params, frames, toks)) > 0


def test_arch_smoke_decode_matches_forward():
    cfg = tiny(ARCH)
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    frames = 0.1 * torch.randn(2, T_ENC, cfg.d_model, generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(2))
    full, _ = model.forward(params, frames, toks)
    cache = model.encode_for_decode(params, frames, model.init_cache(2, 24, T_ENC, device="cpu"))
    errs = []
    for t in range(24):
        cur = torch.full((2,), t, dtype=torch.int32)
        lg, _ = model.decode_step(params, cache, toks[:, t], cur)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 5e-3


@pytest.mark.parametrize("fn", ["init", "init_cache"])
def test_entry_points_default_to_the_card(fn):
    import inspect

    assert inspect.signature(getattr(EncDecTransformer, fn)).parameters["device"].default == "cuda"
