"""The port's slot arena, flat decode WCETs and live device contract
against the JAX package's, on the CPU: the twins of the reference's
``tests/test_slot_arena.py`` and ``tests/test_serving_hotpath.py`` for
the engine and bridge code the cluster path runs.

- The allocator: reuse, exhaustion, double free and bad ids — the same
  rows and the same refusals as the JAX engine, state untouched by a
  refused call; a slot dispatch must step all live rows with distinct
  ids; prefix dispatch is refused while rows are live; an oversize
  decode batch is refused; a recycled row is wiped in place.
- Scattered live rows are bit-identical to a dense decode of only those
  rows (batch size is data), and within 2e-3 of the JAX engine's rows on
  converted parameters.
- A flat decode WCET answers every batch up to ``max_slots`` and is inf
  beyond it, so admission rejects unservable streams: the same verdicts
  as the JAX package's.
- The bridge refuses a category profiled as both kinds, profiles decode
  flat with one build, and live metrics charge ``max_slots`` rows per
  decode job; the engine and the table round batches through one bucket.
- A failed execution raises from the loop instead of completing.
"""
import jax
import numpy as np
import pytest
import torch

from repro import core as J
from repro.configs.registry import tiny as jtiny
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import core as P
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.core.bucketing import bucket
from repro_torch.models import model_for
from repro_torch.models.layers import tree_leaves
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.async_device import AsyncDevice
from repro_torch.serving.batcher_bridge import build_live_scheduler, profile_engine
from repro_torch.serving.engine import InferenceEngine

MID = "granite-3-2b"
SEQ = 16


def _engine(max_slots=8, **kw):
    return InferenceEngine({MID: tiny(MID)}, max_slots=max_slots, device="cpu", **kw)


def _outcome(fn):
    """What a call did: its result, or its refusal's type and message."""
    try:
        out = fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return "ok", out if out is None else tuple(int(x) for x in out)


# (op, args) sequences run on both engines; every call's outcome and the
# live set after it must agree.
ALLOCATOR_PLANS = {
    "reuse": [("alloc", 3), ("free", [1]), ("alloc", 1), ("alloc", 2), ("free", [0, 4])],
    "exhaustion": [("alloc", 4), ("alloc", 1), ("free", [2]), ("alloc", 2), ("alloc", 1)],
    "double-free": [("alloc", 2), ("free", [0, 1]), ("free", [0, 1]), ("free", [1])],
    "bad-ids": [("alloc", 2), ("free", [99]), ("free", [1, 1]), ("free", [3]),
                ("free", [-1]), ("free", []), ("alloc", 0)],
}


@pytest.mark.parametrize("name", list(ALLOCATOR_PLANS))
def test_allocator_matches_jax(name):
    engines = {"jax": JEngine({MID: jtiny(MID)}, max_slots=4), "torch": _engine(4)}
    trail = {}
    for key, e in engines.items():
        steps = []
        for op, arg in ALLOCATOR_PLANS[name]:
            if op == "alloc":
                out = _outcome(lambda: e.alloc_slots(MID, SEQ, arg))
            else:
                out = _outcome(lambda: e.free_slots(MID, SEQ, arg))
            arena = e.arena(MID, SEQ)
            steps.append((out[0], sorted(arena.live), sorted(arena.free),
                          arena.allocs, arena.resets))
        trail[key] = steps
    assert trail["torch"] == trail["jax"]
    refusals = [s for s in trail["torch"] if s[0] != "ok"]
    assert refusals or name == "reuse"


def test_refusal_messages_match_jax():
    msgs = {}
    for key, e in (("jax", JEngine({MID: jtiny(MID)}, max_slots=2)), ("torch", _engine(2))):
        e.alloc_slots(MID, SEQ, 2)
        got = [_outcome(lambda: e.alloc_slots(MID, SEQ, 1)),
               _outcome(lambda: e.free_slots(MID, SEQ, [5])),
               _outcome(lambda: e.free_slots(MID, SEQ, [0, 0])),
               _outcome(lambda: e.dispatch(MID, (SEQ,), 1, kind="decode", slots=(0,))),
               _outcome(lambda: e.dispatch(MID, (SEQ,), 2, kind="decode", slots=(0, 0))),
               _outcome(lambda: e.dispatch(MID, (SEQ,), 2, kind="decode")),
               _outcome(lambda: e.dispatch(MID, (SEQ,), 3, kind="decode"))]
        msgs[key] = got
    assert [t for t, _ in msgs["torch"]] == [t for t, _ in msgs["jax"]]
    for (_, tm), (_, jm) in zip(msgs["torch"], msgs["jax"]):
        assert tm.split(":")[0].split(" — ")[0] == jm.split(":")[0].split(" — ")[0]
    for needle, (_, m) in zip(("exhausted", "out of range", "duplicate", "ALL live rows",
                               "distinct", "allocator-live", "max_slots"), msgs["torch"]):
        assert needle in m


def test_prefix_dispatch_allowed_again_after_free():
    e = _engine(4)
    slots = e.alloc_slots(MID, SEQ, 2)
    with pytest.raises(ValueError, match="allocator-live"):
        e.dispatch(MID, (SEQ,), 2, kind="decode")
    with pytest.raises(ValueError, match="allocator-live"):
        e.decode_chunk(MID, (SEQ,), 2, 1)
    e.free_slots(MID, SEQ, slots)
    assert tuple(e.dispatch(MID, (SEQ,), 2, kind="decode").wait().shape) == (4, 256)


def test_realloc_wipes_recycled_rows_in_place():
    e = _engine(4)
    slots = e.alloc_slots(MID, SEQ, 2)
    e.dispatch(MID, (SEQ,), 2, kind="decode", slots=slots, payload={0: 3, 1: 4}).wait()
    arena = e.arena(MID, SEQ)
    ptrs = [t.data_ptr() for t in tree_leaves(arena.cache)]
    rows = torch.tensor(slots)
    assert any(bool(leaf.index_select(1, rows).abs().sum() > 0)
               for leaf in tree_leaves(arena.cache["super"]))
    e.free_slots(MID, SEQ, slots)
    assert e.alloc_slots(MID, SEQ, 2) == slots
    for leaf in tree_leaves(arena.cache["super"]):
        assert bool((leaf.index_select(1, rows) == 0).all())
    assert [t.data_ptr() for t in tree_leaves(arena.cache)] == ptrs
    assert arena.resets == 4 and arena.cur.tolist()[:2] == [0, 0]


def test_scattered_slots_bit_identical_to_dense_and_close_to_jax():
    jeng = JEngine({MID: jtiny(MID)}, max_slots=8)
    params = interop.params_from_numpy(tiny(MID), jax.tree.map(np.asarray, jeng.params[MID]),
                                       device="cpu")
    e = _engine(8, params={MID: params})
    for eng in (jeng, e):
        eng.alloc_slots(MID, SEQ, 6, start_pos=SEQ - 1)
        eng.free_slots(MID, SEQ, [0, 2, 3])  # live rows 1, 4, 5: scattered
    toks = {1: 17, 4: 3, 5: 250}
    got = e.dispatch(MID, (SEQ,), 3, kind="decode", slots=(1, 4, 5), payload=toks).wait()
    want_j = np.asarray(jeng.dispatch(MID, (SEQ,), 3, kind="decode", slots=(1, 4, 5),
                                      payload=toks).wait())
    model = model_for(tiny(MID))
    dense_cache = model.init_cache(3, SEQ, device="cpu")
    tok = torch.tensor([17, 3, 250], dtype=torch.int32)
    cur = torch.full((3,), SEQ - 1, dtype=torch.int32)
    with torch.no_grad():
        dense, _ = model.decode_step(params, dense_cache, tok, cur)
    rows = [1, 4, 5]
    assert torch.equal(got[rows], dense)
    np.testing.assert_allclose(got[rows].numpy(), want_j[rows], atol=2e-3, rtol=2e-3)


def _flat_verdicts(core):
    t = core.ProfileTable()
    t.record_flat("m", (SEQ,), 0.004, max_slots=8)
    answers = [t.wcet("m", (SEQ,), b) for b in range(0, 10)]
    answers += [t.wcet_optimistic("m", (SEQ,), 3), t.wcet_optimistic("m", (SEQ,), 9),
                t.max_profiled_batch("m", (SEQ,))]
    back = core.ProfileTable.from_json(t.to_json())
    answers += [back.wcet("m", (SEQ,), 5), back.scaled(2.0).wcet("m", (SEQ,), 5)]
    small = core.ProfileTable()
    small.record_flat("m", (SEQ,), 0.0001, max_slots=4)
    verdicts = []
    for period, n in ((0.05, 30), (0.2, 10), (0.12, 20), (0.25, 4)):
        sched = core.DeepRT(small, loop=core.EventLoop())
        res = sched.submit_request(core.Request(
            category=core.Category("m", (SEQ,)), period=period, relative_deadline=1.0,
            n_frames=n))
        verdicts.append((res.admitted, res.phase, res.utilization))
    return answers, verdicts


def test_flat_decode_wcet_and_admission_match_jax():
    answers, verdicts = _flat_verdicts(P)
    assert (answers, verdicts) == _flat_verdicts(J)
    assert answers[1] == answers[8] == 0.004 and answers[9] == float("inf")
    assert answers[0] == 0.0
    assert [v[0] for v in verdicts] == [False, True, False, True]


def test_bridge_profiles_decode_flat_and_refuses_dual_kind():
    e = _engine(4)
    table = profile_engine(e, [(MID, (SEQ,), "decode")], batch_sizes=(1, 2, 4), runs=2)
    key = (MID, (SEQ,))
    assert key in table.flat_entries and table.flat_entries[key][0] == 4
    assert key not in table.entries
    assert e.stats["decode_compiles"] == 1
    with pytest.raises(ValueError, match="both"):
        profile_engine(_engine(4), [(MID, (SEQ,), "prefill"), (MID, (SEQ,), "decode")],
                       batch_sizes=(1, 2), runs=1)


def test_live_metrics_charge_arena_rows_and_rounding_is_shared():
    e = _engine(4)
    sched, engine, table = build_live_scheduler({MID: tiny(MID)}, [(MID, (SEQ,), "decode")],
                                                batch_sizes=(1, 2, 4), engine=e,
                                                profile_runs=2)
    w = table.wcet(MID, (SEQ,), 1)
    req = P.Request(category=P.Category(MID, (SEQ,)), period=max(w * 4, 0.05),
                    relative_deadline=max(w * 24, 0.25), n_frames=4)
    assert sched.submit_request(req).admitted
    m = sched.run()
    assert m.completed_frames == 4 and m.job_count > 0
    assert m.bucket_rows == m.job_count * e.max_slots
    assert sched.nonrt_batch_cap == e.max_slots
    # One bucket rule for the engine's prefill and the table's lookup.
    assert engine_mod.bucket is bucket and not hasattr(engine_mod, "_bucket")
    t = P.ProfileTable()
    for b in (1, 2, 4, 8):
        t.record("m", (16,), b, 0.001 * b + 0.004)
    assert t.wcet("m", (16,), 5) == t.wcet("m", (16,), 8)
    h = e.dispatch(MID, (SEQ,), 3, kind="prefill")
    assert (h.true_batch, h.bucket_batch) == (3, bucket(3)) == (3, 4)
    sched.device.close()


def test_failed_execution_raises_not_completes():
    loop = P.WallClock()

    class BoomHandle:
        def wait(self):
            raise ValueError("kernel launch failed")

    device = AsyncDevice(loop, dispatch_fn=lambda job: BoomHandle())
    completions = []
    device.submit("job", 0.01, lambda j, t: completions.append(j))
    with pytest.raises(RuntimeError, match="device execution failed"):
        loop.run()
    assert completions == []
    assert isinstance(device.last_error, ValueError)
    assert device.idle
