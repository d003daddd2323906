"""The port's MoE FFN and MoE models against the JAX package, on the CPU.

- ``apply_moe`` (the reference's global path) and
  ``apply_moe_dense_reference`` on the same numpy inputs and parameters:
  the same top-k experts, the same keep/slot decisions (the reference's
  stable sort by expert, written out in numpy beside the JAX call), the
  same aux loss and outputs within 2e-5 in float32, at a capacity that
  drops tokens and at 8.0, where nothing drops; a zero router, where
  every probability is 1/E and both packages take experts 0..k-1.
- tiny mixtral-8x7b (top-2) and tiny llama4-maverick (top-1 plus a
  shared expert), parameters from ``repro``'s ``model.init`` through
  ``interop``: forward, prefill and decode logits within 2e-3 of JAX
  (the reference's ``test_model_pallas_matches_xla`` tolerance), also
  against the reference's Pallas path in interpret mode, and the
  ``test_arch_smoke`` shape, finiteness and decode-against-forward
  checks.
- The serving engine: slot-arena decode with dead and idle rows against
  the JAX engine on the same arena state; rows coupled through capacity
  (a decode step drops tokens) against the JAX engine with every row
  live; a k-step chunk bit-equal to k single steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as jtiny
from repro.models import layers as jl
from repro.models import model_for as jmodel_for
from repro.models import moe as jmoe
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import interop
from repro_torch.configs.registry import get_config, tiny
from repro_torch.models import layers as tl
from repro_torch.models import model_for
from repro_torch.models import moe as tmoe
from repro_torch.serving.engine import InferenceEngine

KEY = jax.random.PRNGKey(5)
MIXTRAL = "mixtral-8x7b"
LLAMA4 = "llama4-maverick-400b-a17b"
MOE_ARCHS = (MIXTRAL, LLAMA4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(
        np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32),
        np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float32),
        atol=tol, rtol=tol,
    )


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------
def _moe_inputs(seed, d=32, f=48, e=8, shared=False, router_std=3.0, b=3, s=16):
    """numpy parameters of ``moe_spec``'s shapes and an input batch. The
    router is drawn wide (std ``router_std``) and the tokens share a
    direction, so routing is skewed and a capacity of 1.25 drops tokens."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    p = {"router": n(d, e) * router_std, "gate": n(e, d, f) / np.sqrt(d),
         "up": n(e, d, f) / np.sqrt(d), "down": n(e, f, d) / np.sqrt(f)}
    if shared:
        p["shared"] = {"gate": n(d, f) / np.sqrt(d), "up": n(d, f) / np.sqrt(d),
                       "down": n(f, d) / np.sqrt(f)}
    x = n(b, s, d) + n(d)  # a shared direction crowds the same experts
    return jax.tree.map(lambda a: a.astype(np.float32), p), x


def _both(p):
    return jax.tree.map(jnp.asarray, p), jax.tree.map(_t, p)


def _reference_decisions(top_e, k, e, capacity):
    """The reference's dispatch (``_apply_moe_global``) in numpy: the
    stable sort by expert, ranks from the group starts, keep and slot, in
    sorted order, with the sort order."""
    flat_e = np.asarray(top_e).reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    sorted_e = flat_e[order]
    counts = np.bincount(sorted_e, minlength=e)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(flat_e.size) - starts[sorted_e]
    keep = rank < capacity
    slot = np.where(keep, sorted_e * capacity + rank, e * capacity)
    return order, keep, slot


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("top_k,shared", [(2, False), (1, True), (3, False)])
def test_apply_moe_decisions_and_outputs_match_jax(top_k, shared, capacity_factor):
    e = 8
    p, x = _moe_inputs(11 + top_k, e=e, shared=shared)
    jp, tp = _both(p)
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), top_k=top_k, activation="swiglu",
                                capacity_factor=capacity_factor)
    tout, taux = tmoe.apply_moe(tp, _t(x), top_k=top_k, activation="swiglu",
                                capacity_factor=capacity_factor)
    # Routing: JAX's own top-k on JAX's probabilities.
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    jprobs = jax.nn.softmax(xf @ jp["router"], axis=-1)
    jw, je = jax.lax.top_k(jprobs, top_k)
    plan = tmoe.dispatch_plan(tp["router"], _t(x).reshape(-1, x.shape[-1]), top_k=top_k,
                              capacity_factor=capacity_factor)
    t = x.shape[0] * x.shape[1]
    assert plan.capacity == max(4, int(np.ceil(t * top_k / e * capacity_factor)))
    np.testing.assert_array_equal(plan.top_e.numpy(), np.asarray(je))
    _close(plan.top_w, np.asarray(jw) / np.asarray(jw).sum(-1, keepdims=True), 2e-6)
    order, keep, slot = _reference_decisions(je, top_k, e, plan.capacity)
    np.testing.assert_array_equal(plan.keep.numpy()[order], keep)
    np.testing.assert_array_equal(plan.slot.numpy()[order], slot)
    dropped = int((~keep).sum())
    if capacity_factor == 8.0:
        assert dropped == 0
    else:
        assert dropped > 0  # the skewed router overfills some experts
    _close(taux, jaux, 1e-6)
    _close(tout, jout, 2e-5)
    assert tout.dtype == torch.float32 and tuple(tout.shape) == x.shape


@pytest.mark.parametrize("top_k,shared", [(2, False), (1, True)])
def test_dense_reference_matches_jax_and_the_drop_free_dispatch(top_k, shared):
    p, x = _moe_inputs(21, shared=shared)
    jp, tp = _both(p)
    want = jmoe.apply_moe_dense_reference(jp, jnp.asarray(x), top_k=top_k,
                                          activation="swiglu")
    got = tmoe.apply_moe_dense_reference(tp, _t(x), top_k=top_k, activation="swiglu")
    _close(got, want, 2e-5)
    no_drop, _ = tmoe.apply_moe(tp, _t(x), top_k=top_k, activation="swiglu",
                                capacity_factor=8.0)
    _close(no_drop, got, 2e-5)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_zero_router_ties_take_the_lower_experts_like_jax(top_k):
    p, x = _moe_inputs(31)
    p["router"][:] = 0.0
    jp, tp = _both(p)
    plan = tmoe.dispatch_plan(tp["router"], _t(x).reshape(-1, 32), top_k=top_k)
    _, je = jax.lax.top_k(jnp.full((4, 8), 1.0 / 8), top_k)
    assert np.asarray(je).tolist() == [list(range(top_k))] * 4
    assert (plan.top_e.numpy() == np.arange(top_k)).all()
    _close(plan.top_w, np.full(plan.top_w.shape, 1.0 / top_k), 1e-7)
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), top_k=top_k, activation="swiglu")
    tout, taux = tmoe.apply_moe(tp, _t(x), top_k=top_k, activation="swiglu")
    _close(tout, jout, 2e-5)
    _close(taux, jaux, 1e-6)


def test_combine_sums_a_tokens_terms_in_choice_order():
    """Each (token, choice) term is rounded in x.dtype and the k terms add
    to a zero start in choice order; for k = 2 that is the reference's
    scatter-add bit for bit, whichever order it adds in."""
    p, x = _moe_inputs(41)
    tp = jax.tree.map(lambda a: _t(a).to(torch.bfloat16), p)
    xb = _t(x).to(torch.bfloat16)
    out, _ = tmoe.apply_moe(tp, xb, top_k=2, activation="swiglu", capacity_factor=8.0)
    plan = tmoe.dispatch_plan(tp["router"], xb.reshape(-1, 32), top_k=2, capacity_factor=8.0)
    xf = xb.reshape(-1, 32)
    terms = []
    for j in range(2):
        e_j = plan.top_e[:, j]
        g = torch.einsum("td,tdf->tf", xf, tp["gate"][e_j])
        u = torch.einsum("td,tdf->tf", xf, tp["up"][e_j])
        y = torch.einsum("tf,tfd->td", torch.nn.functional.silu(g) * u, tp["down"][e_j])
        terms.append(y * plan.top_w[:, j:j + 1].to(torch.bfloat16))
    want = (torch.zeros_like(terms[0]) + terms[1]) + terms[0]  # the other order
    assert torch.equal(out.reshape(-1, 32), want)


def test_moe_spec_and_init_draw_experts_at_their_input_width():
    spec = tmoe.moe_spec(64, 96, 4, "swiglu", shared_expert=True)
    jspec = jmoe.moe_spec(64, 96, 4, "swiglu", shared_expert=True)
    shapes = lambda s: jax.tree.map(lambda q: (q.shape, q.axes), s,
                                    is_leaf=lambda q: isinstance(q, (jl.Param, tl.Param)))
    assert shapes(spec) == shapes(jspec)
    gen = torch.Generator().manual_seed(0)
    stacked = tl.map_tree(
        lambda q: tl.Param((6,) + q.shape, ("layer",) + q.axes, q.init, q.scale), spec)
    params = tl.build_params(stacked, gen, device="cpu")
    assert abs(float(params["gate"].std()) - 64 ** -0.5) < 0.05 * 64 ** -0.5
    assert abs(float(params["down"].std()) - 96 ** -0.5) < 0.05 * 96 ** -0.5
    assert abs(float(params["router"].std()) - 0.02) < 0.002


# ---------------------------------------------------------------------------
# MoE models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    """(arch, JAX model, JAX params, port model, port params)."""
    arch = request.param
    jm = jmodel_for(jtiny(arch))
    jp = jm.init(KEY)
    cfg = tiny(arch)
    tp = interop.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return arch, jm, jp, model_for(cfg), tp


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interop_carries_stacked_experts_exactly(arch, dtype):
    cfg = jtiny(arch, param_dtype=dtype)
    tree = jax.tree.map(np.asarray, jmodel_for(cfg).init(KEY))
    params = interop.params_from_numpy(tiny(arch, param_dtype=dtype), tree, device="cpu")
    ffn = params["super"][0]["ffn"]
    n, e, d, f = cfg.n_super, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(ffn["gate"].shape) == (n, e, d, f) and tuple(ffn["down"].shape) == (n, e, f, d)
    assert tuple(ffn["router"].shape) == (n, d, e)
    assert ("shared" in ffn) == (arch == LLAMA4)
    back = interop.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf, np.float32))


def test_forward_and_aux_match_jax(moe_pair):
    arch, jm, jp, tm, tp = moe_pair
    toks = np.random.default_rng(51).integers(0, 256, size=(2, 29)).astype(np.int32)
    jlog, jaux = jm.forward(jp, jnp.asarray(toks))
    tlog, taux = tm.forward(tp, _t(toks))
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == (2, 29, 256)
    _close(tlog, jlog, 2e-3)
    _close(taux, jaux, 2e-5)
    assert float(taux) > 0
    dense = model_for(tiny(arch, impl="dense"))
    _close(dense.forward(tp, _t(toks))[0], tlog, 2e-3)


def test_moe_dense_config_matches_jax(moe_pair):
    arch, _, jp, _, tp = moe_pair
    toks = np.random.default_rng(52).integers(0, 256, size=(2, 13)).astype(np.int32)
    jlog, _ = jmodel_for(jtiny(arch, moe_dense=True)).forward(jp, jnp.asarray(toks))
    tlog, taux = model_for(tiny(arch, moe_dense=True)).forward(tp, _t(toks))
    _close(tlog, jlog, 2e-3)
    assert float(taux) == 0.0


def test_prefill_then_decode_match_jax(moe_pair):
    """Prefill 12 tokens, then 10 decode steps (the decode path's
    capacity factor 2.0): logits against JAX at every step."""
    _, jm, jp, tm, tp = moe_pair
    rng = np.random.default_rng(53)
    b, n_pre, n_dec, max_len = 3, 12, 10, 24
    toks = rng.integers(0, 256, size=(b, n_pre + n_dec)).astype(np.int32)
    jc, tc = jm.init_cache(b, max_len), tm.init_cache(b, max_len, device="cpu")
    jlog, jc = jm.prefill(jp, jc, jnp.asarray(toks[:, :n_pre]))
    tlog, _ = tm.prefill(tp, tc, _t(toks[:, :n_pre]))
    _close(tlog, jlog, 2e-3)
    step = jax.jit(jm.decode_step)
    for t in range(n_dec):
        cur = np.full((b,), n_pre + t, np.int32)
        jlog, jc = step(jp, jc, jnp.asarray(toks[:, n_pre + t]), jnp.asarray(cur))
        tlog, _ = tm.decode_step(tp, tc, _t(toks[:, n_pre + t]), _t(cur))
        _close(tlog, jlog, 2e-3)


def test_mixtral_matches_the_reference_pallas_path():
    """The twin of ``tests/test_kernels.py::test_model_pallas_matches_xla``
    for mixtral: the reference's Pallas path (interpret mode on the CPU)
    against the port's kernel path, no-drop capacity as there."""
    cfg_j = jtiny(MIXTRAL, impl="pallas", moe_capacity_factor=8.0)
    jm = jmodel_for(cfg_j)
    jp = jm.init(KEY)
    toks = jax.random.randint(KEY, (2, 24), 0, cfg_j.vocab_size)
    jlog, _ = jm.forward(jp, toks)
    cfg = tiny(MIXTRAL, moe_capacity_factor=8.0)
    tp = interop.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    tlog, _ = model_for(cfg).forward(tp, _t(np.asarray(toks)))
    _close(tlog, jlog, 2e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_arch_smoke_forward_shapes_and_finite(arch):
    cfg = tiny(arch)
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    logits, aux = model.forward(params, toks)
    assert tuple(logits.shape) == (2, 24, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_arch_smoke_decode_matches_forward(arch):
    # No-drop capacity, as the reference's test_decode_matches_forward.
    cfg = tiny(arch, moe_capacity_factor=8.0)
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    b, s = 2, 24
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(2))
    full, _ = model.forward(params, toks)
    cache = model.init_cache(b, s, device="cpu")
    errs = []
    for t in range(s):
        lg, _ = model.decode_step(params, cache, toks[:, t],
                                  torch.full((b,), t, dtype=torch.int32))
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 5e-3, f"decode/forward divergence {max(errs)}"


def test_full_moe_configs_build_specs_without_allocating():
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        spec = model_for(cfg).spec()
        ffn = spec["super"][0]["ffn"]
        assert ffn["gate"].shape == (cfg.n_super, cfg.n_experts, cfg.d_model, cfg.d_ff)
        n = sum(int(np.prod(q.shape)) for q in tl.tree_leaves(spec))
        norms = (2 * cfg.n_layers + 1) * cfg.d_model
        routers = cfg.n_layers * cfg.d_model * cfg.n_experts
        assert n == cfg.param_count_estimate() + norms + routers


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
def _engines(arch, max_slots, **overrides):
    jeng = JEngine({arch: jtiny(arch, **overrides)}, max_slots=max_slots)
    cfg = tiny(arch, **overrides)
    params = {arch: interop.params_from_numpy(cfg, jax.tree.map(np.asarray, jeng.params[arch]),
                                              device="cpu")}
    return jeng, InferenceEngine({arch: cfg}, max_slots=max_slots, device="cpu", params=params)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_decode_with_dead_rows_matches_jax(arch):
    """Rows 0-2 leased, row 1 freed (dead), row 3 never leased, row 2
    idle on odd steps. Tiny mixtral (k=2 of 4 experts) decodes at a
    capacity of 2kT/E >= T, so no token drops and rows stay independent:
    the live rows' logits agree with the JAX engine's although dead rows
    differ (their attention is exact 0 in the port, ROADMAP.md §C); tiny
    llama4 (k=1) at 2 rows' capacity 4 likewise."""
    jeng, teng = _engines(arch, 4)
    seq = 24
    rng = np.random.default_rng(61)
    toks = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        teng.dispatch(arch, (16,), 2, "prefill", payload=toks).wait().numpy()[:2],
        np.asarray(jeng.dispatch(arch, (16,), 2, "prefill", payload=toks).wait())[:2])
    assert jeng.alloc_slots(arch, seq, 3, start_pos=5) == teng.alloc_slots(arch, seq, 3,
                                                                           start_pos=5)
    jeng.free_slots(arch, seq, [1])
    teng.free_slots(arch, seq, [1])
    live = (0, 2)
    for step in range(8):
        payload = {s: int(rng.integers(0, 256)) for s in live}
        rows = None if step % 2 == 0 else [0]
        jl_ = np.asarray(jeng.dispatch(arch, (seq,), 2, "decode", slots=live,
                                       payload=payload, step_rows=rows).wait())
        tl_ = teng.dispatch(arch, (seq,), 2, "decode", slots=live, payload=payload,
                            step_rows=rows).wait()
        stepped = list(live) if rows is None else rows
        _close(tl_.numpy()[stepped], jl_[stepped], 2e-3)
    np.testing.assert_array_equal(teng.arena(arch, seq).cur.numpy(),
                                  np.asarray(jeng.arena(arch, seq).cur))


def test_engine_rows_coupled_through_capacity_match_jax(monkeypatch):
    """Tiny mixtral with its full 8 experts, top-2, on an 8-row arena:
    a decode step's capacity is max(4, ceil(8 * 2 / 8 * 2.0)) = 4, so a
    fifth row routed to one expert is dropped there and a row's output
    depends on the others (reference behaviour, ROADMAP.md §C). With
    every row live the arena state is the same in both packages, and so
    are the logits; the run must have dropped at least one pair."""
    jeng, teng = _engines(MIXTRAL, 8, n_experts=8)
    seen = []
    real = tmoe.dispatch_plan

    def spy(*a, **kw):
        plan = real(*a, **kw)
        seen.append(int((~plan.keep).sum()))
        return plan

    monkeypatch.setattr(tmoe, "dispatch_plan", spy)
    seq = 20
    rows = jeng.alloc_slots(MIXTRAL, seq, 8, start_pos=0)
    assert teng.alloc_slots(MIXTRAL, seq, 8, start_pos=0) == rows
    rng = np.random.default_rng(62)
    for _ in range(6):
        payload = {s: int(rng.integers(0, 256)) for s in rows}
        jl_ = np.asarray(jeng.dispatch(MIXTRAL, (seq,), 8, "decode", slots=rows,
                                       payload=payload).wait())
        tl_ = teng.dispatch(MIXTRAL, (seq,), 8, "decode", slots=rows, payload=payload).wait()
        _close(tl_, jl_, 2e-3)
    assert sum(seen) > 0, "no token was dropped; the case does not couple rows"


def test_engine_chunk_bit_equal_to_single_steps():
    cfg = tiny(MIXTRAL)
    eng = InferenceEngine({MIXTRAL: cfg}, max_slots=4, chunk_depth=4, device="cpu")
    seq, k = 16, 4
    rows = eng.alloc_slots(MIXTRAL, seq, 3, start_pos=2)
    arena = eng.arena(MIXTRAL, seq)
    leaves = lambda: tl.tree_leaves(arena.cache) + [arena.cur, arena.active]
    rng = np.random.default_rng(63)
    payloads = [{r: int(rng.integers(0, 256)) for r in rows} for _ in range(k)]
    plan = [None, [0, 2], [1], None]
    snap = [t.clone() for t in leaves()]
    chunk = eng.decode_chunk(MIXTRAL, (seq,), 3, k, slots=rows, payloads=payloads,
                             step_rows=plan).wait()
    after = [t.clone() for t in leaves()]
    for t, s in zip(leaves(), snap):
        t.copy_(s)
    steps = [eng.dispatch(MIXTRAL, (seq,), 3, "decode", slots=rows, payload=payloads[i],
                          step_rows=plan[i]).wait() for i in range(k)]
    assert all(torch.equal(chunk[i], steps[i]) for i in range(k))
    assert all(torch.equal(a, b) for a, b in zip(after, leaves()))
