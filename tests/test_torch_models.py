"""The port's model layers, KV cache, attention and transformer against
the JAX package, at tiny sizes on the CPU.

Inputs come from numpy with a seed; parameters come from ``repro``'s
``model.init`` and reach the port through ``repro_torch.interop``.
Tolerances: float32 layers 2e-5, model logits 2e-3 (the reference's
``test_model_pallas_matches_xla``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as jtiny
from repro.models import attention as jattn
from repro.models import kvcache as jkv
from repro.models import layers as jl
from repro.models import model_for as jmodel_for
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, tiny
from repro_torch.models import attention as tattn
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tl
from repro_torch.models import model_for
from repro_torch.models.transformer import model_spec

MID = "granite-3-2b"
KEY = jax.random.PRNGKey(3)


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


@pytest.fixture(scope="module")
def granite():
    """(JAX model, JAX params, port model, port params) for tiny granite."""
    cfg = jtiny(MID)
    jm = jmodel_for(cfg)
    jp = jm.init(KEY)
    tm = model_for(tiny(MID))
    tp = interop.params_from_numpy(tiny(MID), _np_tree(jp), device="cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# interop and configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interop_round_trip_exact(dtype):
    cfg = jtiny(MID, param_dtype=dtype)
    tree = _np_tree(jmodel_for(cfg).init(KEY))
    params = interop.params_from_numpy(tiny(MID, param_dtype=dtype), tree, device="cpu")
    # Stacked superblock leaves keep their leading n_super axis.
    assert params["super"][0]["mixer"]["wq"].shape == tree["super"][0]["mixer"]["wq"].shape
    assert params["super"][0]["mixer"]["wq"].dtype == getattr(torch, dtype)
    back = interop.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf, np.float32))


def test_interop_rejects_mismatched_tree():
    tree = _np_tree(jmodel_for(jtiny(MID)).init(KEY))
    tree["super"][0]["mixer"]["wq"] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        interop.params_from_numpy(tiny(MID), tree, device="cpu")


def test_configs_copied_as_data():
    from repro.configs.registry import ARCHS as JARCHS
    from repro_torch.configs.registry import ARCHS, SHAPES

    assert set(ARCHS) == set(JARCHS)
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    for arch, cfg in ARCHS.items():
        a = dataclasses.asdict(cfg)
        b = dataclasses.asdict(JARCHS[arch])
        # The port's own fields (Mamba-2 sizes, Granite's multipliers) sit
        # at their defaults, which compute what the reference does.
        assert {k: v for k, v in a.items() if k in b} == b, arch
        assert {k: v for k, v in a.items() if k not in b} == {
            k: defaults[k] for k in a if k not in b}, arch
    assert get_config(MID).dtype == torch.bfloat16
    assert tiny(MID).dtype == torch.float32
    assert SHAPES["decode_32k"].seq_len == 32768


def test_init_from_generator_is_seeded_and_matches_spec():
    cfg = tiny(MID)
    m = model_for(cfg)
    p1 = m.init(torch.Generator().manual_seed(5), device="cpu")
    p2 = m.init(torch.Generator().manual_seed(5), device="cpu")
    spec_leaves = tl.tree_leaves(model_spec(cfg))
    leaves1, leaves2 = tl.tree_leaves(p1), tl.tree_leaves(p2)
    assert [tuple(x.shape) for x in leaves1] == [p.shape for p in spec_leaves]
    assert all(torch.equal(a, b) for a, b in zip(leaves1, leaves2))
    assert all(x.dtype == torch.float32 for x in leaves1)
    # rmsnorm scales start at zero (weight is 1 + scale), as in the reference.
    assert torch.count_nonzero(p1["final_norm"]["scale"]) == 0


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-1.6b", "recurrentgemma-9b"])
def test_init_draws_each_matrix_at_its_input_width(arch):
    """Fan-in scaled leaves are drawn at std 1/sqrt(input width): for a
    stacked leaf the width of one layer, never its layer axis; for an
    output projection (heads, head_dim, embed) heads x head_dim."""
    cfg = tiny(arch, n_layers=3, d_model=256, d_ff=512, n_heads=4, n_kv_heads=1,
               head_dim=64, d_rnn=256, vocab_size=64)
    spec = model_spec(cfg)
    params = model_for(cfg).init(torch.Generator().manual_seed(9), device="cpu")
    if arch == "granite-3-2b":
        attn = spec["super"][0]["mixer"]
        assert attn["wq"].shape[0] == cfg.n_super and tl.fan_in(attn["wq"]) == cfg.d_model
        assert tl.fan_in(attn["wo"]) == cfg.n_heads * 64
    checked = 0
    for p, x in zip(tl.tree_leaves(spec), tl.tree_leaves(params)):
        if p.init != "normal" or p.scale is not None or x.numel() < 4096:
            continue
        width = tl.fan_in(p)
        assert width in (cfg.d_model, cfg.d_ff, cfg.d_rnn, cfg.n_heads * 64), (p, width)
        assert abs(float(x.std()) * width ** 0.5 - 1.0) < 0.1, (p, float(x.std()))
        checked += 1
    assert checked >= 4


@pytest.mark.parametrize("fn", [
    "interop.params_from_numpy", "layers.build_params", "layers.rope_frequencies",
    "kvcache.attn_cache_init", "kvcache.ring_cache_init", "recurrent.griffin_init_state",
    "recurrent.rwkv6_init_state", "transformer.init_cache", "transformer.Transformer.init",
    "transformer.Transformer.init_cache", "staging.StagingRing.__init__",
])
def test_entry_points_default_to_the_card(fn):
    """Tensors land on the CPU only when the caller asks for it."""
    import inspect

    from repro_torch.ingest import staging
    from repro_torch.models import recurrent, transformer

    mods = {"interop": interop, "layers": tl, "kvcache": tkv, "recurrent": recurrent,
            "transformer": transformer, "staging": staging}
    head, *rest = fn.split(".")
    obj = mods[head]
    for name in rest:
        obj = getattr(obj, name)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


def test_unported_kinds_raise_naming_the_roadmap():
    # Every block kind and both remaining architectures are ported now:
    # an encoder-decoder config builds the encoder-decoder model, and an
    # M-RoPE model refuses to run without its (3, B, S) positions.
    from repro_torch.models import EncDecTransformer

    assert isinstance(model_for(tiny("whisper-large-v3")), EncDecTransformer)
    cfg = tiny("qwen2-vl-72b")
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((2, 5), dtype=torch.long)
    with pytest.raises(ValueError, match="M-RoPE"):
        model.forward(params, toks)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norms_rope_mlp_embed_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32), np.float32)
    w = rng.standard_normal((32,), np.float32) * 0.1
    bias = rng.standard_normal((32,), np.float32) * 0.1
    _close(tl.rmsnorm(_t(x), _t(w)), jl.rmsnorm(jnp.asarray(x), jnp.asarray(w)), 2e-5)
    _close(tl.layernorm(_t(x), _t(w), _t(bias)),
           jl.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)), 2e-5)
    p = {"scale": w, "bias": bias}
    for kind in ("rmsnorm", "layernorm"):
        _close(tl.apply_norm(_t(x), {k: _t(v) for k, v in p.items()}, kind),
               jl.apply_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, kind),
               2e-5)
    _close(tl.rope_frequencies(16, 10000.0, device="cpu"), jl.rope_frequencies(16, 10000.0), 1e-6)
    xh = rng.standard_normal((2, 7, 3, 16), np.float32)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    _close(tl.apply_rope(_t(xh), _t(pos), 10000.0),
           jl.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 10000.0), 2e-4)
    for act in ("swiglu", "geglu", "gelu"):
        spec = tl.mlp_spec(32, 48, act)
        mp = {k: rng.standard_normal(v.shape, np.float32) * 0.2 for k, v in spec.items()}
        _close(tl.apply_mlp(_t(x), {k: _t(v) for k, v in mp.items()}, act),
               jl.apply_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in mp.items()}, act),
               2e-5)
    table = rng.standard_normal((50, 32), np.float32)
    ids = rng.integers(0, 50, size=(2, 5)).astype(np.int32)
    _close(tl.embed_lookup(_t(table), _t(ids)), jl.embed_lookup(jnp.asarray(table), jnp.asarray(ids)), 0)
    _close(tl.unembed(_t(x), _t(table)), jl.unembed(jnp.asarray(x), jnp.asarray(table)), 2e-5)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def test_kvcache_write_views_and_nbytes_match_jax():
    rng = np.random.default_rng(1)
    b, s, kv, d = 3, 10, 2, 4
    jc = jkv.attn_cache_init(b, s, kv, d, jnp.float32)
    tc = tkv.attn_cache_init(b, s, kv, d, torch.float32, device="cpu")
    k_ptr = tc["k"].data_ptr()
    for step in range(3):
        k = rng.standard_normal((b, 1, kv, d), np.float32)
        v = rng.standard_normal((b, 1, kv, d), np.float32)
        pos = np.array([step, step + 2, 9], np.int32)
        jc = jkv.attn_cache_write(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        out = tkv.attn_cache_write(tc, _t(k), _t(v), _t(pos))
        assert out is tc and tc["k"].data_ptr() == k_ptr  # in place
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
    np.testing.assert_array_equal(tc["v"].numpy(), np.asarray(jc["v"]))
    cur = np.array([2, 4, 9], np.int32)
    jv = jkv.attn_cache_views(jc, jnp.asarray(cur))
    tv = tkv.attn_cache_views(tc, _t(cur))
    for a, e in zip(tv, jv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    assert tkv.cache_nbytes(tc) == jkv.cache_nbytes(jc)


def test_cache_reset_rows_in_place_matches_jax(granite):
    jm, _, tm, _ = granite
    rng = np.random.default_rng(2)
    jc = jm.init_cache(4, 8)
    tc = tm.init_cache(4, 8, device="cpu")
    filled = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), jc)
    jc = jax.tree.map(jnp.asarray, filled)
    for j, entry in enumerate(tc["super"]):
        for name in ("k", "v"):
            entry[name].copy_(_t(filled["super"][j][name]))
    ptrs = [e["k"].data_ptr() for e in tc["super"]]
    rows = np.array([False, True, False, True])
    jr = jkv.cache_reset_rows(jc, jnp.asarray(rows))
    out = tkv.cache_reset_rows(tc, _t(rows))
    assert out is tc and [e["k"].data_ptr() for e in tc["super"]] == ptrs
    for j, entry in enumerate(tc["super"]):
        for name in ("k", "v"):
            np.testing.assert_array_equal(entry[name].numpy(), np.asarray(jr["super"][j][name]))
    assert float(tc["super"][0]["k"][:, 1].abs().sum()) == 0.0
    assert float(tc["super"][0]["k"][:, 0].abs().sum()) > 0.0


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_params(rng, d=32, h=4, kv=2, hd=8):
    spec = jattn.attention_spec(d, h, kv, hd)
    return {k: rng.standard_normal(p.shape, np.float32) * 0.3 for k, p in spec.items()}


@pytest.mark.parametrize("impl", ["xla", "dense"])
def test_mha_matches_jax(impl):
    rng = np.random.default_rng(4)
    p = _attn_params(rng)
    x = rng.standard_normal((2, 11, 32), np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32)[None], (2, 11))
    exp = jattn.mha({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                    jnp.asarray(pos), rope_theta=10000.0)
    out = tattn.mha({k: _t(v) for k, v in p.items()}, _t(x), _t(pos),
                    rope_theta=10000.0, impl=impl)
    _close(out, exp, 2e-5)


@pytest.mark.parametrize("impl", ["xla", "dense"])
def test_mha_decode_with_active_bitmap_matches_jax(impl):
    """Live rows agree with the JAX xla path; under the kernel path
    (impl xla) a dead row gives exactly what the projection of a zero
    attention output gives."""
    rng = np.random.default_rng(5)
    p = _attn_params(rng)
    b, s = 4, 12
    x = rng.standard_normal((b, 1, 32), np.float32)
    ck = rng.standard_normal((b, s, 2, 8), np.float32)
    cv = rng.standard_normal((b, s, 2, 8), np.float32)
    cur = np.array([11, 5, 7, 0], np.int32)
    kv_pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    valid = kv_pos <= cur[:, None]
    active = np.array([True, False, True, True])
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    exp = jattn.mha_decode(jp, jnp.asarray(x), jnp.asarray(cur), jnp.asarray(ck),
                           jnp.asarray(cv), jnp.asarray(kv_pos), jnp.asarray(valid),
                           rope_theta=10000.0, active=jnp.asarray(active))
    tp = {k: _t(v) for k, v in p.items()}
    out = tattn.mha_decode(tp, _t(x), _t(cur), _t(ck), _t(cv), _t(kv_pos), _t(valid),
                           rope_theta=10000.0, impl=impl, active=_t(active))
    live = active
    _close(out[_t(live)], np.asarray(exp)[live], 2e-5)
    if impl == "xla":
        assert float(out[1].abs().max()) == 0.0  # zero attention, no bias


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


def test_forward_matches_jax(granite):
    jm, jp, tm, tp = granite
    toks = np.random.default_rng(6).integers(0, 256, size=(2, 24)).astype(np.int32)
    jl_, _ = jm.forward(jp, jnp.asarray(toks))
    tl_, aux = tm.forward(tp, _t(toks))
    assert tl_.dtype == torch.float32 and tuple(tl_.shape) == (2, 24, 256)
    assert float(aux) == 0.0
    _close(tl_, jl_, 2e-3)


def test_dense_impl_matches_kernel_path(granite):
    _, _, tm, tp = granite
    toks = _t(np.random.default_rng(7).integers(0, 256, size=(2, 19)).astype(np.int32))
    dense = model_for(tiny(MID, impl="dense"))
    pallas = model_for(tiny(MID, impl="pallas"))
    a, _ = tm.forward(tp, toks)
    _close(dense.forward(tp, toks)[0], a, 2e-3)
    _close(pallas.forward(tp, toks)[0], a, 2e-3)


def test_prefill_then_decode_steps_match_jax(granite):
    jm, jp, tm, tp = granite
    rng = np.random.default_rng(8)
    b, n_pre, n_dec, max_len = 3, 9, 5, 16
    toks = rng.integers(0, 256, size=(b, n_pre + n_dec)).astype(np.int32)
    jc = jm.init_cache(b, max_len)
    tc = tm.init_cache(b, max_len, device="cpu")
    jlog, jc = jm.prefill(jp, jc, jnp.asarray(toks[:, :n_pre]))
    tlog, tc2 = tm.prefill(tp, tc, _t(toks[:, :n_pre]))
    assert tc2 is tc
    _close(tlog, jlog, 2e-3)
    step = jax.jit(jm.decode_step)
    active = np.array([True, True, False])
    for t in range(n_dec):
        cur = np.full((b,), n_pre + t, np.int32)
        jlog, jc = step(jp, jc, jnp.asarray(toks[:, n_pre + t]), jnp.asarray(cur),
                        None, jnp.asarray(active))
        tlog, _ = tm.decode_step(tp, tc, _t(toks[:, n_pre + t]), _t(cur), active=_t(active))
        _close(tlog[:2], np.asarray(jlog)[:2], 2e-3)  # live rows only
    # Live rows' caches agree; a dead row's later-layer K/V depend on its
    # (unspecified) hidden state, as its logits do.
    _close(tc["super"][0]["k"][:, :2], np.asarray(jc["super"][0]["k"])[:, :2], 2e-4)


def test_decode_matches_forward():
    """Twin of tests/test_arch_smoke.py::test_decode_matches_forward for
    the ported arch: step-by-step decode reproduces the full forward."""
    cfg = tiny(MID)
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(11), device="cpu")
    b, s = 2, 8
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(12))
    full, _ = model.forward(params, toks)
    cache = model.init_cache(b, s, device="cpu")
    errs = []
    for t in range(s):
        cursor = torch.full((b,), t, dtype=torch.int32)
        lg, cache = model.decode_step(params, cache, toks[:, t], cursor)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 5e-3, f"decode/forward divergence {max(errs)}"
