"""The port's k-step decode chunks on the CPU: the twin of the engine and
bridge parts of ``tests/test_decode_chunking.py``.

- The differential oracle inside the port: one k-step ``decode_chunk`` on
  engine A against the same schedule as k single-step ``dispatch`` calls
  on a twin engine B, bit-identical (every arena leaf, cursors, active
  bitmap, every step's logits and argmax), for tiny granite-3-2b,
  rwkv6-1.6b and recurrentgemma-9b, over every scenario of the
  reference's ``TestDifferentialOracle``.
- ``TestChunkValidation``'s five cases.
- Parity with the JAX package: the port's ``decode_chunk`` against the
  JAX engine's on the same leases, payloads and step rows, float32 tiny
  models with converted parameters, at 2e-3 on live rows (ROADMAP.md §C).
- The bridge: ``profile_engine`` records a monotone chunk family, a live
  ``build_live_scheduler(chunk_depth=4)`` backlog fuses chunks with zero
  decode builds after profiling, and a chunk whose member carries a
  payload without leases is refused.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as jtiny
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.core import Category, ChunkJob, Frame, JobInstance
from repro_torch.models.layers import tree_leaves
from repro_torch.serving.batcher_bridge import build_live_scheduler, profile_engine
from repro_torch.serving.engine import InferenceEngine

MID = "granite-3-2b"
SEQ = 24  # recurrentgemma's 16-slot ring wraps for rows near the end
SHAPE = (SEQ,)
M = 8
DEPTHS = (1, 2, 4, 8)
# recurrentgemma at 5 layers: one (rglru, rglru, swa) superblock and a
# two-layer tail after the swa layer, as the full model has.
ARCHS = {MID: {}, "rwkv6-1.6b": {}, "recurrentgemma-9b": {"n_layers": 5}}

# (alloc plan, k, per-step rows, token seed): the reference's scenarios.
SCENARIOS = {
    **{f"all-rows-k{k}": (([(M, 3)], set()), k, [None] * k, 10 + k) for k in DEPTHS},
    **{f"scattered-idle-k{k}": (([(M, 2)], {0, 2, 5, 7}), k,
                                [[1, 4], [], None, [3, 6]][:k], 21) for k in (2, 4)},
    "heterogeneous-cursors": (([(4, 2), (4, 9)], {1, 5}), 4,
                              [[0, 4], [2, 3, 6, 7], None, [0]], 33),
    "cursor-clamp": (([(3, SEQ - 2)], set()), 4, [None] * 4, 44),
    "depth-one": (([(5, 4)], {1}), 1, [[0, 2]], 55),
}


def _engine(arch=MID, chunk_depth=8, params=None, seed=0):
    return InferenceEngine({arch: tiny(arch, **ARCHS[arch])}, seed=seed, max_slots=M,
                           chunk_depth=chunk_depth, device="cpu",
                           params=None if params is None else {arch: params})


def _lease(e, arch, plan):
    """Apply an alloc/free sequence; returns the live rows."""
    allocs, frees = plan
    for n, start in allocs:
        e.alloc_slots(arch, SEQ, n, start_pos=start)
    if frees:
        e.free_slots(arch, SEQ, sorted(frees))
    return list(e.arena(arch, SEQ).live)


def _payloads(live, rows_plan, seed):
    rng = np.random.default_rng(seed)
    return [{int(r): int(rng.integers(0, 256)) for r in (live if rows is None else rows)}
            for rows in rows_plan]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_chunk_is_bit_identical_to_single_steps(arch, scenario):
    """THE oracle: a k-step chunk on engine A against the same schedule as
    k single-step dispatches on twin engine B (same parameters)."""
    plan, k, rows_plan, tok_seed = SCENARIOS[scenario]
    a = _engine(arch)
    b = _engine(arch, params=a.params[arch])
    live = _lease(a, arch, plan)
    assert _lease(b, arch, plan) == live
    payloads = _payloads(live, rows_plan, tok_seed)
    aa, ab = a.arena(arch, SEQ), b.arena(arch, SEQ)
    pre_cur = aa.cur.clone()
    ptrs = [t.data_ptr() for t in tree_leaves(aa.cache)]

    h = a.decode_chunk(arch, SHAPE, len(live), k, slots=live, payloads=payloads,
                       step_rows=rows_plan)
    chunk_logits = h.wait()
    step_logits = [
        b.dispatch(arch, SHAPE, len(live), "decode", slots=live, payload=payloads[i],
                   step_rows=rows_plan[i]).wait()
        for i in range(k)
    ]

    assert h.steps == k and tuple(chunk_logits.shape) == (k, M, 256)
    for la, lb in zip(tree_leaves(aa.cache), tree_leaves(ab.cache)):
        assert torch.equal(la, lb)
    assert torch.equal(aa.cur, ab.cur) and torch.equal(aa.active, ab.active)
    for i in range(k):
        assert torch.equal(chunk_logits[i], step_logits[i])
        assert torch.equal(chunk_logits[i].argmax(-1), step_logits[i].argmax(-1))
    # A row advances once per step it carried a frame in, clamped at
    # seq-1; idle leased rows stay frozen.
    for r in live:
        steps = sum(1 for rows in rows_plan if rows is None or r in rows)
        assert int(aa.cur[r]) == min(int(pre_cur[r]) + steps, SEQ - 1)
    assert [t.data_ptr() for t in tree_leaves(aa.cache)] == ptrs
    assert a.stats["chunk_steps"] == k and a.stats["dispatches"] == 1


class TestChunkValidation:
    def test_depth_beyond_ring_capacity_rejected(self):
        e = _engine(chunk_depth=1)
        e.alloc_slots(MID, SEQ, 2)
        with pytest.raises(ValueError, match="chunk_depth"):
            e.decode_chunk(MID, SHAPE, 2, 4, slots=[0, 1])

    def test_payload_and_rows_lengths_must_match_depth(self):
        e = _engine()
        live = list(e.alloc_slots(MID, SEQ, 2))
        with pytest.raises(ValueError, match="payloads"):
            e.decode_chunk(MID, SHAPE, 2, 4, slots=live, payloads=[None] * 3)
        with pytest.raises(ValueError, match="row sets"):
            e.decode_chunk(MID, SHAPE, 2, 4, slots=live, step_rows=[None] * 2)

    def test_step_rows_must_be_live(self):
        e = _engine()
        live = list(e.alloc_slots(MID, SEQ, 2))
        with pytest.raises(ValueError, match="not live"):
            e.decode_chunk(MID, SHAPE, 2, 2, slots=live, step_rows=[[live[0]], [7]])

    def test_prefix_chunk_refuses_leased_arena(self):
        e = _engine()
        e.alloc_slots(MID, SEQ, 2)
        with pytest.raises(ValueError, match="allocator-live"):
            e.decode_chunk(MID, SHAPE, 2, 2)

    def test_chunk_is_one_dispatch_zero_recompiles(self):
        e = _engine()
        live = list(e.alloc_slots(MID, SEQ, 4))
        e.decode_chunk(MID, SHAPE, 4, 4, slots=live).wait()  # first build
        e.reset_stats()
        e.decode_chunk(MID, SHAPE, 4, 4, slots=live).wait()
        assert e.stats["decode_compiles"] == 0
        assert e.stats["dispatches"] == 1
        assert e.stats["chunk_steps"] == 4


def _close(got, want, tol=2e-3):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_chunk_matches_jax_decode_chunk(arch):
    """The port's chunk against the JAX engine's on the same leases,
    payloads and step rows: logits, arena leaves and cursors at 2e-3 on
    live rows. Rows idle at some steps. The port holds an idle row's
    recurrent state, the reference advances it on a phantom zero token
    (ROADMAP.md, "Deliberate departures"), so for the recurrent archs a
    row is compared only until it first idles. granite's idle-step KV
    write lands at the frozen cursor and is overwritten by the row's next
    step, so every live row is compared."""
    cfg = tiny(arch, **ARCHS[arch])
    jeng = JEngine({arch: jtiny(arch, **ARCHS[arch])}, max_slots=M, chunk_depth=4)
    params = interop.params_from_numpy(cfg, jax.tree.map(np.asarray, jeng.params[arch]),
                                       device="cpu")
    teng = _engine(arch, chunk_depth=4, params=params)
    plan = ([(4, 2), (3, 9)], {1, 5})
    live = _lease(teng, arch, plan)
    for n, start in plan[0]:
        jeng.alloc_slots(arch, SEQ, n, start_pos=start)
    jeng.free_slots(arch, SEQ, sorted(plan[1]))
    assert list(jeng.arena(arch, SEQ).live) == live == [0, 2, 3, 4, 6]
    rows_plan = [None, [0, 2, 4, 6], [0, 3], None]
    payloads = _payloads(live, rows_plan, 7)
    recurrent = arch != MID
    idled = set()
    for _ in range(2):
        tl = teng.decode_chunk(arch, SHAPE, len(live), 4, slots=live, payloads=payloads,
                               step_rows=rows_plan).wait()
        jl = np.asarray(jeng.decode_chunk(arch, SHAPE, len(live), 4, slots=live,
                                          payloads=payloads, step_rows=rows_plan).wait())
        for i, rows in enumerate(rows_plan):
            rows = live if rows is None else rows
            compared = [r for r in rows if not (recurrent and r in idled)]
            _close(tl[i][compared], jl[i][compared])
            idled |= set(live) - set(rows)
    assert idled == {2, 3, 4, 6}
    np.testing.assert_array_equal(teng.arena(arch, SEQ).cur.numpy(),
                                  np.asarray(jeng.arena(arch, SEQ).cur))
    assert teng.arena(arch, SEQ).cur.tolist() == [10, 2, 8, 8, 15, 9, 15, 0]
    tcache, jcache = teng.arena(arch, SEQ).cache, jeng.arena(arch, SEQ).cache
    for part in ("super", "tail"):
        axis = 1 if part == "super" else 0
        rows = sorted(set(live) - idled) if recurrent else live
        for te, je in zip(tcache[part], jcache[part]):
            for name, leaf in te.items():
                _close(leaf.index_select(axis, torch.tensor(rows)),
                       np.asarray(je[name]).take(rows, axis))


def test_profile_engine_records_monotone_chunk_family():
    e = _engine(chunk_depth=4)
    table = profile_engine(e, [(MID, SHAPE, "decode")], runs=2, chunk_depth=4)
    assert table.chunk_depths_profiled(MID, SHAPE) == [1, 2, 4]
    w = [table.chunk_wcet(MID, SHAPE, k) for k in (1, 2, 4)]
    assert 0 < w[0] <= w[1] <= w[2]
    assert e.stats["decode_compiles"] == 4  # the step and three chunk depths


def _decode_jobs(cat, n, now, payload=None):
    jobs = []
    for i in range(n):
        f = Frame(request_id=0, category=cat, index=i, arrival_time=now,
                  deadline=now + 30.0, payload=payload)
        jobs.append(JobInstance(category=cat, frames=[f], release_time=now,
                                relative_deadline=30.0, shape_key=SHAPE))
    return jobs


def test_live_backlog_fuses_chunks_with_zero_decode_builds():
    sched, engine, table = build_live_scheduler(
        {MID: tiny(MID)}, [(MID, SHAPE, "decode")], chunk_depth=4, device="cpu",
        profile_runs=2)
    assert table.chunk_depths_profiled(MID, SHAPE) == [1, 2, 4]
    assert sched.worker.chunk_policy is not None
    jobs = _decode_jobs(Category(MID, SHAPE), 8, sched.loop.now)
    for j in jobs:
        sched.worker.submit(j)
    sched.loop.run(until=sched.loop.now + 5.0)
    assert len(sched.worker.completed_jobs) == 8
    assert sched.metrics.chunk_submits >= 1
    assert sched.metrics.chunked_steps >= 2
    # Profiling built every depth on the ladder: serving built nothing.
    assert engine.stats["decode_compiles"] == 0
    assert engine.stats["chunk_steps"] >= 2


def test_bridge_refuses_chunk_payload_without_leases():
    sched, engine, _ = build_live_scheduler(
        {MID: tiny(MID)}, [(MID, SHAPE, "decode")], chunk_depth=2, device="cpu",
        profile_runs=1)
    cat = Category(MID, SHAPE)
    chunk = ChunkJob(_decode_jobs(cat, 2, 0.0, payload=np.int32(5)))
    with pytest.raises(RuntimeError, match="no arena leases"):
        sched.device.dispatch_fn(chunk)
    zero = ChunkJob(_decode_jobs(cat, 2, 0.0))
    assert engine.job_bytes(MID, SHAPE, 1, "decode", steps=2) > engine.job_bytes(
        MID, SHAPE, 1, "decode")
    h = sched.device.dispatch_fn(zero)
    assert h.steps == 2 and tuple(h.wait().shape) == (2, engine.max_slots, 256)
    sched.device.close()
