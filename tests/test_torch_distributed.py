"""Multi-rank numerics of the port's sharded paths, on gloo ranks on the
CPU (processes started here, a file store, no network), each joined with
a timeout so a hang fails the test rather than eating the suite's limit.

- A tiny granite train step on a (2, 2) ("data", "model") mesh against
  one process: the losses and every state leaf after 2 steps agree within
  1e-5 of each leaf's max abs in float32 (reductions regroup across
  ranks).
- MoE's local path at data = 2 against the global path on each
  half-batch: the port's bit for bit with the same routing decisions,
  the reference's within 2e-5 of the output's max abs (and its top-k
  experts the same).
- ``compressed_pod_mean`` over 2 ranks, the twin of
  ``tests/test_training_substrate.py::TestCompression``: the mean of
  each rank's own dequantized codes (the reference's quantizer), and
  error feedback keeps the running bias bounded.

Parameters come from the JAX package's own init, through ``interop``.
"""
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as ref_tiny
from repro.models import model_for as ref_model_for
from repro.models import moe as ref_moe
from repro.training.compression import _dequantize as ref_dequantize
from repro.training.compression import _quantize as ref_quantize
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.models import model_for, moe
from repro_torch.models.layers import tree_leaves
from repro_torch.training import train_loop

JOIN_S = 150
TRAIN_STEPS = 2
TRAIN_TOL = 1e-5
MOE_TOL = 2e-5


def _spawn(target, world, tmp_path, *args):
    """Run ``target(rank, world, store_path, *args)`` on ``world`` spawned
    processes; fail (after killing them) if any is not done in JOIN_S."""
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=target, args=(r, world, store) + args) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, f"{len(alive)} rank(s) hung past {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"ranks exited with {codes}"


def _init(rank, world, store):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)


def _batches(cfg):
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
            for _ in range(TRAIN_STEPS)]


def _train_worker(rank, world, store, params_path, out_path):
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    _init(rank, world, store)
    try:
        mesh = make_host_mesh(model_axis=2, device="cpu")
        cfg = tiny("granite-3-2b")
        model = model_for(cfg)
        params = torch.load(params_path)
        state = train_loop.TrainState(params=train_loop.trainable(params),
                                      opt=train_loop.opt.init(params))
        state = train_loop.place_state(state, train_loop.shardings_for_state(model, mesh))
        step = train_loop.make_train_step(model, train_loop.TrainConfig())
        shd.install_activation_resolver(mesh)
        losses = []
        try:
            for tokens in _batches(cfg):
                state, met = step(state, train_loop.place_batch({"tokens": tokens}, mesh))
                losses.append(float(met["loss"]))
        finally:
            shd.clear_activation_resolver()
        full = train_loop.full_state(state)
        if rank == 0:
            torch.save((losses, [t.detach() for t in tree_leaves(list(full))]), out_path)
    finally:
        dist.destroy_process_group()


def _ref_params(arch, seed=0):
    """(the reference's tiny config, its init, the same as port tensors)."""
    cfg = ref_tiny(arch)
    jp = ref_model_for(cfg).init(jax.random.PRNGKey(seed))
    return cfg, jp, interop.params_from_numpy(tiny(arch), jax.tree.map(np.asarray, jp),
                                              device="cpu")


def _one_process(cfg, params):
    model = model_for(cfg)
    params = train_loop.trainable(params)
    state = train_loop.TrainState(params=params, opt=train_loop.opt.init(params))
    step = train_loop.make_train_step(model, train_loop.TrainConfig())
    losses = []
    for tokens in _batches(cfg):
        state, met = step(state, {"tokens": tokens})
        losses.append(float(met["loss"]))
    return losses, [t.detach() for t in tree_leaves(list(state))]


def test_tiny_train_step_on_a_2x2_mesh_matches_one_process(tmp_path):
    """Each leaf within 1e-5 of its max abs of the one-process float32
    run, or, where float32 itself departs from the float64 run by more
    than that (norm scales that start at zero, AdamW's moments of summed
    gradients: up to 3.7e-4 here), no further than float32's own
    departure: the mesh's regrouped reductions are another rounding, not
    another result."""
    _, _, params = _ref_params("granite-3-2b")
    cfg = tiny("granite-3-2b")
    torch.save(params, tmp_path / "params.pt")
    want_losses, want = _one_process(cfg, _ref_params("granite-3-2b")[2])
    _, exact = _one_process(cfg, _to_double(_ref_params("granite-3-2b")[2]))

    _spawn(_train_worker, 4, tmp_path, str(tmp_path / "params.pt"), str(tmp_path / "out.pt"))
    losses, got = torch.load(tmp_path / "out.pt")
    np.testing.assert_allclose(losses, want_losses, rtol=TRAIN_TOL, atol=0)
    assert len(got) == len(want) == len(exact)
    for i, (g, w, x) in enumerate(zip(got, want, exact)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        scale = max(float(w.abs().max()), 1e-30)
        err = float((g.double() - w.double()).abs().max())
        f32_own = float((w.double() - x).abs().max())
        assert err <= max(TRAIN_TOL * scale, f32_own), (i, tuple(w.shape), err, scale, f32_own)


def _to_double(tree):
    if isinstance(tree, dict):
        return {k: _to_double(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_double(v) for v in tree]
    return tree.double()


def _moe_worker(rank, world, store, in_path, out_path):
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding_hooks
    from repro_torch.models.layers import build_axes

    _init(rank, world, store)
    try:
        mesh = make_host_mesh(model_axis=1, device="cpu")
        p, x, kw = torch.load(in_path)
        spec = moe.moe_spec(x.shape[-1], p["gate"].shape[-1], p["router"].shape[1],
                            kw["activation"], "shared" in p)
        sh = shd.tree_shardings(p, build_axes(spec), mesh)
        placed = {k: ({kk: shd.place(vv, sh[k][kk]) for kk, vv in v.items()}
                      if isinstance(v, dict) else shd.place(v, sh[k])) for k, v in p.items()}
        xd = shd.place(x, train_loop.batch_sharding(mesh, tuple(x.shape),
                                                    ("batch", "seq", "embed")))
        plans = []
        real_plan = moe.dispatch_plan

        def record(*a, **k):
            plan = real_plan(*a, **k)
            plans.append({f: getattr(plan, f) for f in ("top_e", "keep", "slot")})
            return plan

        moe.dispatch_plan = record
        sharding_hooks.set_moe_mesh(mesh)
        try:
            out, aux = moe.apply_moe(placed, xd, **kw)
        finally:
            sharding_hooks.clear_moe_mesh()
            moe.dispatch_plan = real_plan
        assert moe.local_calls == 1 and len(plans) == 1
        full_out, full_aux = out.full_tensor(), aux.full_tensor()
        gathered = [None] * world
        dist.all_gather_object(gathered, plans[0])
        if rank == 0:
            torch.save((full_out, full_aux, gathered), out_path)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b"])
def test_local_moe_path_at_data_2_matches_global_per_half(arch, tmp_path):
    ref_cfg, jp, tp = _ref_params(arch)
    first = lambda tree: jax.tree.map(lambda a: a[0], tree)
    jlayer = first(jp["super"][0]["ffn"])
    p = {k: ({kk: vv[0].contiguous() for kk, vv in v.items()} if isinstance(v, dict)
             else v[0].contiguous()) for k, v in tp["super"][0]["ffn"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, ref_cfg.d_model)).astype(np.float32)
    kw = dict(top_k=ref_cfg.top_k, activation=ref_cfg.activation)
    torch.save((p, torch.from_numpy(x), kw), tmp_path / "in.pt")
    _spawn(_moe_worker, 2, tmp_path, str(tmp_path / "in.pt"), str(tmp_path / "out.pt"))
    out, aux, plans = torch.load(tmp_path / "out.pt")

    halves = [torch.from_numpy(x[:2]), torch.from_numpy(x[2:])]
    port = [moe._apply_moe_global(p, h, **kw) for h in halves]
    ref = [ref_moe._apply_moe_global(jlayer, jnp.asarray(x[i * 2:(i + 1) * 2]), **kw)
           for i in range(2)]
    want_port = torch.cat([o for o, _ in port])
    want_ref = np.concatenate([np.asarray(o) for o, _ in ref])
    # Each shard runs the global path on its own rows: the port's own
    # global path on that half, bit for bit; the reference's within
    # MOE_TOL of the output's max abs.
    assert torch.equal(out, want_port)
    assert float((aux - (port[0][1] + port[1][1]) / 2).abs()) <= 1e-7  # the ranks' mean
    scale = float(np.abs(want_ref).max())
    np.testing.assert_allclose(out.numpy(), want_ref, atol=MOE_TOL * scale, rtol=0)
    np.testing.assert_allclose(float(aux), np.mean([float(a) for _, a in ref]),
                               atol=MOE_TOL, rtol=0)
    for r, h in enumerate(halves):
        plan = moe.dispatch_plan(p["router"], h.reshape(-1, h.shape[-1]), top_k=kw["top_k"])
        for f in ("top_e", "keep", "slot"):
            assert torch.equal(plans[r][f], getattr(plan, f)), (r, f)
        # The reference's top-k experts for the same rows.
        xf = jnp.asarray(h.reshape(-1, h.shape[-1]).numpy())
        probs = jax.nn.softmax(xf @ jnp.asarray(p["router"].numpy()), -1)
        _, ref_e = jax.lax.top_k(probs, kw["top_k"])
        np.testing.assert_array_equal(plans[r]["top_e"].numpy(), np.asarray(ref_e))


def _compression_worker(rank, world, store, in_path, out_path):
    import torch.distributed as dist

    from repro_torch.training.compression import compressed_pod_mean

    _init(rank, world, store)
    try:
        grads = torch.load(in_path)
        r = torch.zeros_like(grads[0][rank])
        outs = []
        for g in grads:
            mean, r = compressed_pod_mean(g[rank], r, dist.group.WORLD)
            outs.append((mean, r))
        if rank == 0:
            torch.save(outs, out_path)
        else:
            torch.save(outs, out_path + ".1")
    finally:
        dist.destroy_process_group()


def test_compressed_pod_mean_over_two_ranks(tmp_path):
    rng = np.random.default_rng(11)
    rounds = [torch.from_numpy(rng.standard_normal((2, 1000)).astype(np.float32))
              for _ in range(4)]
    torch.save(rounds, tmp_path / "g.pt")
    _spawn(_compression_worker, 2, tmp_path, str(tmp_path / "g.pt"), str(tmp_path / "out.pt"))
    outs = [torch.load(tmp_path / "out.pt"), torch.load(str(tmp_path / "out.pt") + ".1")]
    residual = [np.zeros(1000, np.float32), np.zeros(1000, np.float32)]
    sent_sum = np.zeros(1000, np.float64)
    true_sum = np.zeros(1000, np.float64)
    for i, g in enumerate(rounds):
        own = []
        for rank in range(2):
            x = jnp.asarray(g[rank].numpy() + residual[rank])
            codes, scale = ref_quantize(x)
            deq = np.asarray(ref_dequantize(codes, scale, 1000))
            own.append(deq)
            residual[rank] = np.asarray(x) - deq
            np.testing.assert_allclose(outs[rank][i][1].numpy(), residual[rank], atol=1e-6)
        mean = (own[0] + own[1]) / 2
        for rank in range(2):  # every rank holds the same mean
            np.testing.assert_allclose(outs[rank][i][0].numpy(), mean, atol=1e-6)
        # One round's error is bounded by the quantization step.
        bound = max(float(np.abs(g[r].numpy() + 0).max()) for r in range(2)) * 2 / 127
        assert float(np.abs(mean - g.numpy().mean(0)).max()) <= bound
        sent_sum += mean
        true_sum += g.numpy().mean(0)
    # Error feedback: what was sent over all rounds differs from the true
    # total only by what is still held back in the residuals.
    held = (residual[0] + residual[1]) / 2
    np.testing.assert_allclose(sent_sum + held, true_sum, atol=1e-4)


def test_workers_run_under_a_timeout(tmp_path):
    """The spawn helper fails a hung rank instead of waiting forever."""
    global JOIN_S
    saved, JOIN_S = JOIN_S, 3
    try:
        with pytest.raises(AssertionError, match="hung"):
            _spawn(_sleeper, 1, tmp_path)
    finally:
        JOIN_S = saved


def _sleeper(rank, world, store):
    import time

    time.sleep(60)
