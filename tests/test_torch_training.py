"""The port's training slice against the JAX package, at tiny sizes on the
CPU: losses and gradients of the ten architectures, AdamW, the data
pipeline, int8 compression, train steps, checkpoints of a train state and
the train launcher.

The reference runs its default ``impl="xla"``; parameters come from
``repro``'s own ``model.init`` and reach the port through
``repro_torch.interop``; data comes from numpy with a seed. On the CPU the
port's kernels are their plain versions, each differentiable. Tolerances:
losses 1e-5 relative; gradient leaves 1e-4 of each leaf's max abs, except
where float32 rounding alone moves a gradient further (``GRAD_TOL``, each
with its measurement); the optimizer's parameters 1e-6 and moments 1e-7; loss trajectories 1e-4
relative; grad accumulation against one batch at the reference's own
2e-3.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs.registry import tiny as jtiny
from repro.models import model_for as jmodel_for
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import SyntheticTokens as JSyntheticTokens
from repro_torch import interop
from repro_torch.checkpoint.checkpoint import CheckpointManager, leaf_paths
from repro_torch.configs.registry import tiny
from repro_torch.models import model_for
from repro_torch.models.layers import map_tree, tree_leaves
from repro_torch.training import compression as tcomp
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.training.data import DataConfig, SyntheticTokens

KEY = jax.random.PRNGKey(0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-2b", "gemma3-12b", "mixtral-8x7b", "qwen2-vl-72b", "whisper-large-v3",
         "rwkv6-1.6b", "recurrentgemma-9b", "phi4-mini-3.8b", "llama3-405b",
         "llama4-maverick-400b-a17b")
B, S, T_ENC = 2, 24, 20


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree):
    """{checkpoint name: float64 numpy} of a tree of tensors or arrays."""
    out = {}
    for name, leaf in leaf_paths(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().double().numpy()
        out[name] = np.asarray(leaf, np.float64)
    return out


def _vl_positions(prefixes, grid=(2, 3)):
    """Qwen2-VL position ids (3, B, S): text, one image, text."""
    gh, gw = grid
    n = gh * gw
    pos = np.zeros((3, len(prefixes), S), np.int32)
    for r, p in enumerate(prefixes):
        pos[:, r, :p] = np.arange(p)
        pos[0, r, p:p + n] = p
        pos[1, r, p:p + n] = p + np.repeat(np.arange(gh), gw)
        pos[2, r, p:p + n] = p + np.tile(np.arange(gw), gh)
        pos[:, r, p + n:] = p + max(gh, gw) + np.arange(S - p - n)
    return pos


def _batch(arch, seed=0):
    """A numpy batch for ``arch``: tokens (+ M-RoPE positions), or whisper's
    frames and decoder tokens."""
    rng = np.random.default_rng(seed)
    cfg = tiny(arch)
    if cfg.encdec:
        return {"frames": (0.1 * rng.standard_normal((B, T_ENC, cfg.d_model))).astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.rope_kind == "mrope":
        out["positions"] = _vl_positions([3, 10])
    return out


def _jax_loss_fn(jm, batch):
    if "frames" in batch:
        return lambda p: jm.loss(p, jnp.asarray(batch["frames"]), jnp.asarray(batch["dec_tokens"]))
    pos = batch.get("positions")
    pos = None if pos is None else jnp.asarray(pos)
    return lambda p: jm.loss(p, jnp.asarray(batch["tokens"]), pos)


def _port_loss(model, params, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "frames" in t:
        return model.loss(params, t["frames"], t["dec_tokens"])
    return model.loss(params, t["tokens"], t.get("positions"))


def _grad_tree(loss, params):
    it = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return map_tree(lambda _: next(it), params)


# Gradient tolerances (of each leaf's max abs) beyond the default 1e-4,
# where float32 rounding alone moves the gradient further. tiny gemma3:
# the reference's own float32 gradient differs from its result with 64-bit
# types enabled (``jax.enable_x64``) by 2.1e-3 (granite's: 3.7e-4), and the
# port's by 2.4e-3. whisper: the cross-attention query bias's gradient is a
# cancellation (max 1.6e-3, the port 2.7e-7 off, 1.7e-4 of it). tiny
# llama3 (rope theta 5e5, untied head): the port's float32 embed gradient
# is 1.5e-4 of its max from the port's own float64 gradient (wk 1.4e-4),
# the reference's 4.9e-5, the two float32 results 2.0e-4 apart (wk 1.8e-4).
GRAD_TOL = {"gemma3-12b": 5e-3, "whisper-large-v3": 1e-3, "llama3-405b": 3e-4}


def _assert_grads_close(got_tree, want_tree, tol=1e-4):
    """Every leaf present in both, each within ``tol`` of its max abs."""
    got, want = _named(got_tree), _named(want_tree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        bound = tol * max(np.abs(w).max(), 1e-30)
        err = np.abs(got[name] - w).max()
        assert err <= bound, f"{name}: max abs err {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, JAX model, JAX params, port model, port params, batch)."""
    arch = request.param
    jm = jmodel_for(jtiny(arch))
    jp = jm.init(KEY)
    tp = ttl.trainable(interop.params_from_numpy(tiny(arch), _np(jp), device="cpu"))
    return arch, jm, jp, model_for(tiny(arch)), tp, _batch(arch)


def test_loss_and_every_gradient_match_jax(family):
    """``loss`` and every gradient leaf against ``jax.value_and_grad`` of the
    reference's ``loss``: no leaf goes without a gradient."""
    arch, jm, jp, tm, tp, batch = family
    loss_fn = _jax_loss_fn(jm, batch)
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jp)
    loss = _port_loss(tm, tp, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=0)
    _assert_grads_close(_grad_tree(loss, tp), _np(jg), GRAD_TOL.get(arch, 1e-4))


def test_remat_gives_equal_gradients(family):
    """Per-layer remat (torch.utils.checkpoint) recomputes the same
    activations: gradients torch.equal to remat off."""
    arch, _, _, tm, tp, batch = family
    rm = model_for(dataclasses.replace(tiny(arch), remat=True))
    off = tree_leaves(_grad_tree(_port_loss(tm, tp, batch), tp))
    on = tree_leaves(_grad_tree(_port_loss(rm, tp, batch), tp))
    assert all(torch.equal(a, b) for a, b in zip(off, on))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 5), "b": (7,), "stack": [(2, 4, 3)]}
    mk = lambda f: {"w": f(shapes["w"]), "b": f(shapes["b"]), "stack": [f(shapes["stack"][0])]}
    params = mk(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = mk(lambda s: (3 * rng.standard_normal(s)).astype(np.float32))
    m = mk(lambda s: (0.1 * rng.standard_normal(s)).astype(np.float32))
    v = mk(lambda s: (0.01 * rng.random(s)).astype(np.float32))
    return params, grads, m, v


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_matches_reference(clip):
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip)
    params, grads, m, v = _opt_case()
    jstate = jopt.AdamWState(step=jnp.asarray(4, jnp.int32), m=jax.tree.map(jnp.asarray, m),
                             v=jax.tree.map(jnp.asarray, v))
    jp, js, jmet = jopt.update(jopt.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, grads), jstate,
                               jax.tree.map(jnp.asarray, params))
    tt = lambda tree: map_tree(lambda a: torch.from_numpy(a.copy()), tree)
    tstate = topt.AdamWState(step=torch.tensor(4, dtype=torch.int32), m=tt(m), v=tt(v))
    tp, ts, tmet = topt.update(topt.AdamWConfig(**cfg), tt(grads), tstate, tt(params))
    assert int(ts.step) == int(js.step) == 5
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-7)
    for got, want, tol in ((tp, jp, 1e-6), (ts.m, js.m, 1e-7), (ts.v, js.v, 1e-7)):
        g, w = _named(got), _named(_np(want))
        for name in w:
            np.testing.assert_allclose(g[name], w[name], atol=tol, rtol=0, err_msg=name)


def test_adamw_update_is_in_place_and_keeps_dtype():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = topt.init(params)
    assert state.m["w"].dtype == torch.float32 and state.step.dtype == torch.int32
    w = params["w"]
    out, new, _ = topt.update(topt.AdamWConfig(peak_lr=0.1, warmup_steps=1),
                              {"w": torch.full((4,), 2.0)}, state, params)
    assert out["w"] is w and w.dtype == torch.bfloat16 and new.m["w"] is state.m["w"]
    assert float(w[0]) < 1.0 and int(new.step) == 1


def test_cosine_lr_matches_reference_over_steps():
    cfg = dict(peak_lr=3e-3, warmup_steps=7, total_steps=40, min_lr_ratio=0.1)
    for s in range(0, 46):
        np.testing.assert_allclose(float(topt.cosine_lr(topt.AdamWConfig(**cfg), s)),
                                   float(jopt.cosine_lr(jopt.AdamWConfig(**cfg), jnp.array(s))),
                                   rtol=1e-6, atol=1e-12)


def test_clip_norm_reports_pre_clip_and_scales():
    cfg = topt.AdamWConfig(clip_norm=1.0, warmup_steps=1)
    params = {"w": torch.zeros(3)}
    _, state, met = topt.update(cfg, {"w": torch.full((3,), 100.0)}, topt.init(params), params)
    assert float(met["grad_norm"]) == pytest.approx(100.0 * 3 ** 0.5)
    # clipped to unit norm: m = (1 - b1) * g / |g|
    np.testing.assert_allclose(state.m["w"].numpy(), (1 - cfg.b1) / 3 ** 0.5, rtol=1e-6)


def test_adamw_decreases_quadratic():
    cfg = topt.AdamWConfig(peak_lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.init(params)
    for _ in range(60):
        params, state, _ = topt.update(cfg, {"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1.0


# ---------------------------------------------------------------------------
# data and compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host_slice", [None, (0, 2), (1, 2), (2, 4)])
def test_synthetic_tokens_equal_reference(host_slice):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=7)
    got = SyntheticTokens(DataConfig(**kw))
    want = JSyntheticTokens(JDataConfig(**kw))
    for i in (0, 5, 123):
        a = got.batch(i, host_slice=host_slice)["tokens"]
        b = want.batch(i, host_slice=host_slice)["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shape", [(1000,), (3, 700), (256,), (5,)])
def test_quantize_codes_equal_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.flat[0] = 0.5  # ties round half to even
    codes, scale = tcomp._quantize(torch.from_numpy(x))
    jcodes, jscale = jcomp._quantize(jnp.asarray(x))
    assert codes.dtype == torch.int8 and np.array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    n = shape[-1]
    np.testing.assert_array_equal(tcomp._dequantize(codes, scale, n).numpy(),
                                  np.asarray(jcomp._dequantize(jcodes, jscale, n)))


def test_single_pod_compressed_mean_matches_reference():
    """One pod: the gather is the identity; mean + residual give back the
    gradient, and both equal the reference's under a one-device shard_map."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    rng = np.random.default_rng(3)
    g = rng.standard_normal((64,)).astype(np.float32)
    r = (0.01 * rng.standard_normal((64,))).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
    jout, jres = jax.jit(shard_map(lambda g, r: jcomp.compressed_pod_mean(g, r, "pod"),
                                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                                   check_rep=False))(jnp.asarray(g), jnp.asarray(r))
    out, res = tcomp.compressed_pod_mean(torch.from_numpy(g), torch.from_numpy(r), None)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), atol=1e-6, rtol=0)
    np.testing.assert_allclose((out + res).numpy(), g + r, atol=1e-5)
    tree = {"a": torch.from_numpy(g), "b": [torch.from_numpy(r)]}
    res0 = tcomp.init_residuals(tree)
    assert res0["a"].shape == (64,) and res0["b"][0].dtype == torch.float32
    means, _ = tcomp.compress_tree_pod_mean(tree, res0)
    torch.testing.assert_close(means["a"], tcomp.compressed_pod_mean(tree["a"], res0["a"])[0])


def test_compressed_mean_over_a_process_group(tmp_path):
    """The pod group as a torch.distributed group (gloo, one process): the
    all_gather path gives the single-pod result."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        g = torch.randn(300, generator=torch.Generator().manual_seed(1))
        r = torch.zeros(300)
        got = tcomp.compressed_pod_mean(g, r, dist.group.WORLD)
        want = tcomp.compressed_pod_mean(g, r, None)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# train steps, checkpoints of a train state, the launcher
# ---------------------------------------------------------------------------

GRANITE = "granite-3-2b"


def _both_states(cfg_adamw, grad_accum=1):
    jm = jmodel_for(jtiny(GRANITE))
    jstate = jtl.init_state(jm, KEY)
    tstate = interop.train_state_from_numpy(tiny(GRANITE), _np(jstate), device="cpu")
    tm = model_for(tiny(GRANITE))
    jstep = jax.jit(jtl.make_train_step(jm, jtl.TrainConfig(
        adamw=jopt.AdamWConfig(**cfg_adamw), grad_accum=grad_accum)))
    tstep = ttl.make_train_step(tm, ttl.TrainConfig(adamw=topt.AdamWConfig(**cfg_adamw),
                                                    grad_accum=grad_accum))
    return jm, jstate, jstep, tm, tstate, tstep


def test_five_steps_follow_jax_and_step_two_gradients_match():
    """5 steps of tiny granite from one JAX-initialised TrainState: the loss
    trajectory within 1e-4 of the JAX jit's. Before step 2 a no-grad
    forward fills the model's view cache (as serving would), then JAX's
    step-2 parameters are copied into the port's parameter tensors in
    place (as an optimizer writes them; Adam's first steps amplify float32
    noise in near-zero gradients, so the two packages' own step-2
    parameters differ at the learning rate's scale): the gradients there
    match JAX's, through the same model object, at 1e-3 of each leaf's max
    abs (measured: 3.1e-4 in the embedding; at step 0, 9.7e-5)."""
    cfg = dict(peak_lr=5e-3, warmup_steps=2, total_steps=30)
    jm, jstate, jstep, tm, tstate, tstep = _both_states(cfg)
    data = SyntheticTokens(DataConfig(256, 32, 4, seed=0))
    jl, tl = [], []
    for i in range(5):
        toks = data.batch(i)["tokens"]
        if i == 2:
            with torch.no_grad():
                tm.forward(tstate.params, torch.from_numpy(toks))
                for p, a in zip(tree_leaves(tstate.params),
                                tree_leaves(interop.params_from_numpy(
                                    tiny(GRANITE), _np(jstate.params), device="cpu"))):
                    p.copy_(a)
            _, jg = jax.value_and_grad(jm.loss)(jstate.params, jnp.asarray(toks))
            tg = _grad_tree(tm.loss(tstate.params, torch.from_numpy(toks)), tstate.params)
            _assert_grads_close(tg, _np(jg), 1e-3)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert int(tstate.opt.step) == 5


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-large-v3"])
def test_train_step_on_positions_and_encdec_batches_matches_jax(arch):
    """One step on an M-RoPE batch (positions (3, B, S)) and on a whisper
    batch (frames, dec_tokens), each with grad_accum 2, against JAX: loss
    at 1e-5, gradient norm at 1e-4; an Adam step moves an element with a
    near-zero gradient by up to lr (1 + wd |p|) either way on float32
    noise (measured: 0.1% of elements beyond 1e-5, the largest 4.9e-3), so
    every parameter within 2.2 lr and at most 0.5% beyond 1e-5."""
    cfg = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    jm = jmodel_for(jtiny(arch))
    jstate = jtl.init_state(jm, KEY)
    tstate = interop.train_state_from_numpy(tiny(arch), _np(jstate), device="cpu")
    batch = _batch(arch, seed=4)
    jnew, jmet = jax.jit(jtl.make_train_step(jm, jtl.TrainConfig(
        adamw=jopt.AdamWConfig(**cfg), grad_accum=2)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tmet = ttl.make_train_step(model_for(tiny(arch)), ttl.TrainConfig(
        adamw=topt.AdamWConfig(**cfg), grad_accum=2))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    g, w = _named(tnew.params), _named(_np(jnew.params))
    off = 0
    for name in w:
        np.testing.assert_allclose(g[name], w[name], atol=2.2 * cfg["peak_lr"], rtol=0,
                                   err_msg=name)
        off += int((np.abs(g[name] - w[name]) > 1e-5).sum())
    assert off <= 0.005 * sum(x.size for x in w.values())


def test_grad_accum_matches_large_batch():
    cfg = tiny(GRANITE)
    tm = model_for(cfg)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 16, 4, seed=5))
    batch = {"tokens": torch.from_numpy(data.batch(0)["tokens"])}
    mk = lambda k: ttl.make_train_step(tm, ttl.TrainConfig(
        adamw=topt.AdamWConfig(peak_lr=1e-2, warmup_steps=1), grad_accum=k))
    init = lambda: ttl.init_state(tm, torch.Generator().manual_seed(0), device="cpu")
    s1, _ = mk(1)(init(), batch)
    s2, _ = mk(2)(init(), batch)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-3, rtol=0)


def test_train_resume_is_bit_identical(tmp_path):
    """Train 6 steps straight vs 3 + checkpoint + restore + 3."""
    cfg = tiny(GRANITE)
    tm = model_for(cfg)
    step = ttl.make_train_step(tm, ttl.TrainConfig(
        adamw=topt.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)))
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 16, 2, seed=3))
    init = lambda: ttl.init_state(tm, torch.Generator().manual_seed(0), device="cpu")

    def run(state, lo, hi):
        for i in range(lo, hi):
            state, _ = step(state, {"tokens": torch.from_numpy(data.batch(i)["tokens"])})
        return state

    straight = run(init(), 0, 6)
    half = run(init(), 0, 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, half, blocking=True)
    restored = mgr.restore(3, init(), device="cpu")
    ttl.trainable(restored.params)
    assert isinstance(restored, ttl.TrainState) and isinstance(restored.opt, topt.AdamWState)
    resumed = run(restored, 3, 6)
    for (na, a), (nb, b) in zip(leaf_paths(straight), leaf_paths(resumed)):
        assert na == nb and torch.equal(a, b), na


def test_train_state_checkpoints_cross_between_packages(tmp_path):
    """A JAX-written TrainState restores in the port and the port's in JAX;
    both name leaves ``.params[...]``, ``.opt.step``, ``.opt.m[...]``."""
    jm = jmodel_for(jtiny(GRANITE))
    jstate = jtl.init_state(jm, KEY)
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.asarray(7, jnp.int32),
        m=jax.tree.map(lambda p: p * 0.5, jstate.opt.m),
        v=jax.tree.map(lambda p: p + 0.25, jstate.opt.v)))
    JCheckpointManager(str(tmp_path / "jax")).save(7, jstate, blocking=True)
    target = interop.train_state_from_numpy(tiny(GRANITE), _np(jtl.init_state(jm, KEY)),
                                            device="cpu")
    got = CheckpointManager(str(tmp_path / "jax")).restore(7, target, device="cpu")
    assert int(got.opt.step) == 7 and got.opt.step.dim() == 0
    names = [n for n, _ in leaf_paths(got)]
    assert ".opt.step" in names and ".params['embed']" in names
    assert ".opt.m['embed']" in names and ".opt.v['final_norm']['scale']" in names
    want = _named(_np(jstate))
    for name, a in _named(got).items():
        np.testing.assert_array_equal(a, want[name], err_msg=name)

    CheckpointManager(str(tmp_path / "port")).save(7, got, blocking=True)
    back = JCheckpointManager(str(tmp_path / "port")).restore(7, jtl.abstract_state(jm))
    assert isinstance(back, jtl.TrainState)
    for name, a in _named(_np(back)).items():
        np.testing.assert_array_equal(a, want[name], err_msg=name)


def _launcher(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", GRANITE, "--tiny",
         "--steps", "12", "--batch", "2", "--seq", "32", "--ckpt-every", "5", *args],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=600)


def test_train_launcher_with_crash_resume(tmp_path):
    """The fault-tolerance drill through the CLI on the CPU: train, crash,
    resume from the checkpoint, finish; the final state is bit-equal to a
    run that never crashed."""
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"]
    r1 = _launcher(ck + ["--fail-at", "7"], tmp_path)
    assert r1.returncode != 0 and "simulated failure" in (r1.stdout + r1.stderr)
    r2 = _launcher(ck, tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resuming from checkpoint step 5" in r2.stdout
    assert "step   11" in r2.stdout
    r3 = _launcher(["--ckpt-dir", str(tmp_path / "straight"), "--device", "cpu"], tmp_path)
    assert r3.returncode == 0, r3.stderr[-2000:]
    digest = lambda out: [ln for ln in out.splitlines() if ln.startswith("final state digest")]
    assert digest(r2.stdout) == digest(r3.stdout) and len(digest(r3.stdout)) == 1


def test_train_launcher_defaults_to_the_card(monkeypatch):
    """Without --device the launcher asks for CUDA, and raises on a machine
    without it."""
    from repro_torch.launch import train as launcher

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.setattr(sys, "argv", ["train", "--tiny", "--steps", "1"])
    with pytest.raises(SystemExit, match="CUDA"):
        launcher.main()
