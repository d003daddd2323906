"""The port's ingest gateway against the JAX package's, on the CPU.

- Sources: every ``FrameSource`` kind gives bit-equal plans (offsets and
  payload bytes) for one seed in both packages, and the same refusals.
- The gateway over a simulated DeepRT (virtual time): lifecycle,
  rejection, early close, end-to-end latency and the shedder under a
  2.5x burst overload (drop and subsample) make identical decisions:
  frame records, shed verdicts, metrics and span sequences.
- The gateway over ``build_live_cluster`` (tiny granite-3-2b, float32;
  the port's engines on the JAX engines' parameters through ``interop``
  and ``params=``): camera streams' leased-row logits within 2e-3 of
  the JAX cluster's, step for step; each stream's row bit-equal to a
  twin engine of the same ``max_slots`` replaying only that stream's
  tokens in that row; leases released on shed and on close; a frame
  that lost its lease drained without stepping any row; a same-window
  collision counted; payload decode without leases refused; a burst of
  leased frames fused into chunks on the slot-aware chunk path, each
  chunk step bit-equal to the twin's single step.
"""
import jax
import numpy as np
import pytest
import torch

import repro.ingest as JI
from repro import core as J
from repro.configs.registry import tiny as jtiny
from repro.serving.batcher_bridge import build_live_cluster as jbuild
from repro_torch import core as P
from repro_torch import ingest as PI
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.core import ChunkJob, Frame, JobInstance
from repro_torch.serving.batcher_bridge import build_live_cluster as tbuild
from repro_torch.serving.batcher_bridge import build_live_scheduler
from repro_torch.serving.engine import InferenceEngine

MID = "granite-3-2b"
SEQ = 16
SEQ_D = 8
PKG = {"jax": (J, JI), "torch": (P, PI)}


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------
def _sources(core, ing):
    req = core.Request(category=core.Category(MID, (SEQ,)), period=0.15,
                       relative_deadline=0.3, n_frames=5)
    return {
        "periodic": ing.PeriodicSource(period=0.1, n_frames=9, payload_shape=(SEQ,), seed=3),
        "camera": ing.CameraSource(period=0.1, n_frames=12, jitter_frac=0.5,
                                   payload_shape=(SEQ,), seed=7),
        "camera-scalar": ing.CameraSource(period=0.2, n_frames=8, payload_shape=(), seed=40),
        "burst": ing.BurstSource(period=0.1, n_frames=20, burst=4, duty=0.5,
                                 payload_shape=(), seed=6),
        "trace": ing.TraceSource(req, payload_shape=(4,), vocab=1000, seed=11),
    }


@pytest.mark.parametrize("kind", ["periodic", "camera", "camera-scalar", "burst", "trace"])
def test_source_plans_bit_equal_to_jax(kind):
    want = _sources(J, JI)[kind].plan()
    got = _sources(P, PI)[kind].plan()
    assert [f.offset for f in got] == [f.offset for f in want]
    for g, w in zip(got, want):
        assert g.payload.dtype == w.payload.dtype and np.array_equal(g.payload, w.payload)
    assert [f.offset for f in _sources(P, PI)[kind].plan()] == [f.offset for f in got]


def test_trace_sources_and_refusals_match_jax():
    pairs = {}
    for name, (core, ing) in PKG.items():
        spec = core.TraceSpec(mean_period=0.2, mean_deadline=0.4, n_requests=3,
                              models=(MID,), shapes=((SEQ,),), seed=5)
        pairs[name] = [(r.period, r.relative_deadline, r.n_frames,
                        [(f.offset, f.payload.tolist()) for f in s.plan()])
                       for r, s in ing.TraceSource.from_trace(spec, payload_shape=(SEQ,))]
        for kw, match in ((dict(period=0.0, n_frames=5), "period"),
                          (dict(period=0.1, n_frames=5, jitter_frac=1.5), "jitter")):
            with pytest.raises(ValueError, match=match):
                ing.CameraSource(**kw)
        with pytest.raises(ValueError, match="duty"):
            ing.BurstSource(period=0.1, n_frames=5, duty=0.0)
        with pytest.raises(ValueError, match="mode"):
            ing.ShedPolicy(mode="sometimes")
    assert pairs["torch"] == pairs["jax"] and len(pairs["jax"]) == 3


def test_ingest_exports_match_jax_but_the_transport():
    transport = {"LinkFault", "LinkPlan", "SimLink", "TransportServer", "TransportSession",
                 "TransportSource", "UdpClientLink", "UdpServerBinding", "DROP", "DUPLICATE",
                 "HELLO_RETRY", "MALFORMED", "REORDER", "LINK_DELAY", "LINK_FAULT_KINDS"}
    assert set(JI.__all__) - transport == set(PI.__all__) - {"check_payload_dtype"}


# ---------------------------------------------------------------------------
# The gateway over a simulated DeepRT
# ---------------------------------------------------------------------------
CAT_SHAPE = (4,)


def _sim(core, ing, a=0.01, c=0.04, **gw):
    table = core.ProfileTable()
    for b in (1, 2, 4, 8, 16, 32):
        table.record("m", CAT_SHAPE, b, a + c * b)
    sched = core.DeepRT(table)
    tracer = core.FrameTracer()
    sched.attach_tracer(tracer, tag="solo")
    gateway = ing.IngestGateway(sched, **gw)
    gateway.tracer = tracer
    return sched, gateway, tracer, core.Category("m", CAT_SHAPE)


def scenario_lifecycle(core, ing):
    sched, gw, tracer, cat = _sim(core, ing)
    src = ing.CameraSource(period=0.2, n_frames=10, jitter_frac=0.4, payload_shape=(4,),
                           seed=4)
    s = gw.register(src, cat, relative_deadline=0.5)
    sched.run()
    return sched, [s], tracer


def scenario_rejected(core, ing):
    sched, gw, tracer, cat = _sim(core, ing, a=0.5, c=0.5)
    s = gw.register(ing.CameraSource(period=0.1, n_frames=5, payload_shape=(4,), seed=0),
                    cat, relative_deadline=0.2)
    sched.run()
    return sched, [s], tracer


def scenario_close(core, ing):
    sched, gw, tracer, cat = _sim(core, ing)
    s = gw.register(ing.CameraSource(period=0.2, n_frames=10, payload_shape=(4,), seed=1),
                    cat, relative_deadline=0.5)
    sched.run(until=0.7)
    gw.close(s)
    sched.run()
    return sched, [s], tracer


def _overload(mode, shedding=True, penalty=None):
    def scenario(core, ing):
        sched, gw, tracer, cat = _sim(core, ing, shedding=shedding,
                                      default_policy=ing.ShedPolicy(mode=mode))
        if penalty is not None:
            sched.adaptation.penalties[cat] = penalty
        src = ing.BurstSource(period=0.1, n_frames=50, burst=5, duty=0.4, payload_shape=(4,),
                              seed=6)
        s = gw.register(src, cat, relative_deadline=0.2)
        sched.run()
        return sched, [s], tracer
    return scenario


GATEWAY_SCENARIOS = {
    "lifecycle": scenario_lifecycle,
    "rejected": scenario_rejected,
    "close": scenario_close,
    "overload-no-shed": _overload("drop", shedding=False),
    "overload-drop": _overload("drop"),
    "overload-subsample": _overload("subsample"),
    "overload-penalized": _overload("drop", penalty=0.05),
}


def _gateway_summary(sched, sessions, tracer):
    ids = {}

    def rid(r):
        return ids.setdefault(r, len(ids)) if r is not None and r >= 0 else r

    m = sched.metrics
    return dict(
        sessions=[(s.state, s.frames_ingested, s.frames_delivered, s.frames_dropped,
                   s.last_shed_reason, s.conserved()) for s in sessions],
        records=sorted((rid(r), i, v) for (r, i), v in m.frame_records.items()),
        counts=(m.completed_frames, m.missed_frames, m.dropped_frames, m.delivered_frames,
                m.ingested_frames, m.job_count),
        drops={rid(r): n for r, n in m.drops_by_request.items()},
        sheds={str(c): n for c, n in sched.adaptation.sheds.items()},
        latencies=list(m.frame_latencies), e2e=list(m.e2e_latencies),
        spans=[(ev.t, ev.stage, rid(ev.rid), ev.idx, ev.where, ev.cat) for ev in tracer.ring],
    )


@pytest.mark.parametrize("name", list(GATEWAY_SCENARIOS))
def test_gateway_decisions_match_jax_in_simulation(name):
    want = _gateway_summary(*GATEWAY_SCENARIOS[name](J, JI))
    got = _gateway_summary(*GATEWAY_SCENARIOS[name](P, PI))
    assert got == want
    assert all(s[-1] for s in got["sessions"])
    if name in ("overload-drop", "overload-subsample", "overload-penalized"):
        assert got["counts"][2] > 0


def test_late_frame_after_timer_retirement_flushes_like_jax():
    done = {}
    for name, (core, _ing) in PKG.items():
        sched, _gw, _t, cat = _sim(core, _ing)
        req = core.Request(category=cat, period=0.1, relative_deadline=0.4, n_frames=2)
        assert sched.submit_request(req, external_arrivals=True).admitted
        sched.ingest_frame(req, 0, payload=np.zeros(4, np.int32))
        sched.run()
        sched.loop.schedule(sched.loop.now + 1.0,
                            lambda: sched.ingest_frame(req, 1, payload=np.zeros(4, np.int32)))
        done[name] = (sched.run().completed_frames, sched.loop.now)
    assert done["torch"] == done["jax"] and done["torch"][0] == 2


# ---------------------------------------------------------------------------
# The gateway over live clusters
# ---------------------------------------------------------------------------
CATS = [(MID, (SEQ,), "prefill"), (MID, (SEQ_D,), "decode")]


def _converted(jslices):
    jparams = next(iter(jslices.values())).engine.params[MID]
    return {MID: interop.params_from_numpy(tiny(MID), jax.tree.map(np.asarray, jparams),
                                           device="cpu")}


def _spy(slices):
    """Record (leases at dispatch, job, handle) per slice, in dispatch order."""
    captured = {name: [] for name in slices}
    for name, sl in slices.items():
        inner = sl.device.dispatch_fn

        def spy(job, _inner=inner, _sl=sl, _out=captured[name]):
            leases = {rid: lease[2][0] for rid, lease in _sl.leases.items()}
            handle = _inner(job)
            _out.append((leases, job, handle))
            return handle

        sl.device.dispatch_fn = spy
    return captured


def stream_steps(captured, rid):
    """(row, staged token, that step's logits row) for every decode step
    in which stream ``rid`` had a frame: one step per job, one per chunk
    member; the earliest frame's token is the one staged."""
    steps = []
    for leases, job, handle in captured:
        if rid not in leases:
            continue
        out = handle.wait()
        members = job.jobs if isinstance(job, ChunkJob) else [job]
        for i, member in enumerate(members):
            frames = [f for f in member.frames if f.request_id == rid]
            if not frames:
                continue
            tok = int(np.asarray(frames[0].payload))
            logits = out[i] if isinstance(job, ChunkJob) else out
            steps.append((leases[rid], tok, logits[leases[rid]]))
    return steps


def twin_replay(engine, seq, steps):
    """The same steps on a twin engine of the same ``max_slots`` holding
    only this stream, in its row: each step's logits row."""
    twin = InferenceEngine(engine.configs, max_slots=engine.max_slots, device=engine.device,
                           params=engine.params)
    row = steps[0][0]
    assert all(r == row for r, _, _ in steps)
    twin.alloc_slots(MID, seq, row + 1)
    if row:
        twin.free_slots(MID, seq, list(range(row)))
    return [twin.dispatch(MID, (seq,), 1, "decode", slots=[row], payload={row: tok}).wait()[row]
            for _, tok, _ in steps]


def _gateway_cluster(core, ing, build, n_slices=1, **kw):
    cluster, slices = build({MID: kw.pop("cfg")}, CATS,
                            slice_names=tuple(f"s{i}" for i in range(n_slices)),
                            batch_sizes=(1, 2, 4), profile_runs=2, nonrt_cap=1, **kw)
    captured = _spy(slices)
    gw = ing.IngestGateway(cluster, shedding=False)
    sessions = [gw.register(ing.CameraSource(period=0.2, n_frames=4, payload_shape=(),
                                             seed=20 + i),
                            core.Category(MID, (SEQ_D,)), relative_deadline=0.4)
                for i in range(3)]
    cluster.run()
    return cluster, slices, sessions, captured


@pytest.fixture(scope="module")
def served():
    jcl, jslices, jsessions, jcap = _gateway_cluster(J, JI, jbuild, cfg=jtiny(MID))
    tcl, tslices, tsessions, tcap = _gateway_cluster(P, PI, tbuild, cfg=tiny(MID),
                                                     device="cpu",
                                                     params=_converted(jslices))
    return (jcl, jslices, jsessions, jcap), (tcl, tslices, tsessions, tcap)


def test_live_gateway_streams_served_and_conserved(served):
    for cluster, slices, sessions, _ in served:
        assert [s.state for s in sessions] == ["active"] * 3
        agg = cluster.aggregate_metrics()
        assert agg["completed_frames"] + agg["dropped_frames"] == 12
        assert all(s.conserved() for s in sessions)
        for sl in slices.values():
            assert sl.engine.stats["decode_compiles"] == 0
            assert sl.leases == {}
            for ring in sl.engine._rings.values():
                assert ring.host_allocs == ring.depth
            for arena in sl.engine._arenas.values():
                assert len(arena.free) == arena.max_slots


# Which streams share a decode step: stream indices per step.
STEP_PLAN = [[0, 1, 2], [0, 2], [1], [0, 1, 2], [2, 0], [1, 2]]


def _leased_steps(core, ing, build, **kw):
    """Three leased decode streams on one slice, stepped by jobs whose
    composition is fixed (submitted to the EDF worker in deadline order,
    as windows would release them) and whose tokens come from a seeded
    generator; returns the captured dispatches and the streams."""
    cluster, slices = build({MID: kw.pop("cfg")}, CATS, slice_names=("s0",),
                            batch_sizes=(1, 2, 4), profile_runs=2, nonrt_cap=1, **kw)
    captured = _spy(slices)
    sched = slices["s0"].scheduler
    cat = core.Category(MID, (SEQ_D,))
    counts = [sum(i in step for step in STEP_PLAN) for i in range(3)]
    reqs = [core.Request(category=cat, period=1.0, relative_deadline=1.0, n_frames=n)
            for n in counts]
    for r in reqs:
        assert cluster.submit_request(r, external_arrivals=True)
    toks = np.random.default_rng(12).integers(0, 256, size=(len(STEP_PLAN), 3))
    now = cluster.loop.now
    sent = [0, 0, 0]
    for k, step in enumerate(STEP_PLAN):
        frames = []
        for i in step:
            sched.metrics.record_ingest()
            frames.append(core.Frame(request_id=reqs[i].request_id, category=cat,
                                     index=sent[i], arrival_time=now,
                                     deadline=now + 30.0 + k, payload=np.int32(toks[k, i])))
            sent[i] += 1
        sched.worker.submit(core.JobInstance(category=cat, frames=frames, release_time=now,
                                             relative_deadline=30.0 + k,
                                             shape_key=(SEQ_D,)))
    cluster.run()
    assert slices["s0"].leases == {}
    return captured["s0"], reqs, slices


def test_live_leased_row_logits_match_jax():
    jcap, jreqs, jslices = _leased_steps(J, JI, jbuild, cfg=jtiny(MID))
    tcap, treqs, tslices = _leased_steps(P, PI, tbuild, cfg=tiny(MID), device="cpu",
                                         params=_converted(jslices))
    checked = 0
    for jr, tr in zip(jreqs, treqs):
        want = stream_steps(jcap, jr.request_id)
        got = stream_steps(tcap, tr.request_id)
        assert [(r, t) for r, t, _ in got] == [(r, t) for r, t, _ in want]
        for (_, _, g), (_, _, w) in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3)
            checked += 1
    assert checked == sum(len(step) for step in STEP_PLAN)
    # The port's rows are bit-equal to its own single-stream twins.
    for r in treqs:
        steps = stream_steps(tcap, r.request_id)
        for (_, _, got), want in zip(steps, twin_replay(tslices["s0"].engine, SEQ_D, steps)):
            assert torch.equal(got, want)


def test_live_gateway_rows_bit_equal_to_twin_replay(served):
    _, (_, tslices, tsessions, tcap) = served
    engine = tslices["s0"].engine
    for s in tsessions[:2]:
        steps = stream_steps(tcap["s0"], s.request_id)
        assert len(steps) >= 2
        for (_, _, got), want in zip(steps, twin_replay(engine, SEQ_D, steps)):
            assert torch.equal(got, want)


def _one_slice(core, build, **kw):
    return build({MID: kw.pop("cfg")}, [(MID, (SEQ_D,), "decode")], slice_names=("s0",),
                 batch_sizes=(1, 2), profile_runs=2, nonrt_cap=1, **kw)


def _both(fn):
    jout = fn(J, JI, jbuild, cfg=jtiny(MID))
    tout = fn(P, PI, tbuild, cfg=tiny(MID), device="cpu")
    return jout, tout


def test_same_window_collision_counted_like_jax():
    def run(core, ing, build, **kw):
        cluster, slices = _one_slice(core, build, **kw)
        sched = slices["s0"].scheduler
        req = core.Request(category=core.Category(MID, (SEQ_D,)), period=0.2,
                           relative_deadline=0.4, n_frames=2)
        assert cluster.submit_request(req, external_arrivals=True)
        sched.ingest_frame(req, 0, payload=np.int32(7))
        sched.ingest_frame(req, 1, payload=np.int32(9))
        cluster.run()
        m = sched.metrics
        return m.completed_frames, m.payload_collisions, m.delivered_frames, slices["s0"].leases

    jout, tout = _both(run)
    assert tout == jout == (2, 1, 2, {})


def test_leaseless_frame_drains_without_stepping_a_row_like_jax():
    def run(core, ing, build, **kw):
        cluster, slices = _one_slice(core, build, **kw)
        sl = slices["s0"]
        sched = sl.scheduler
        cat = core.Category(MID, (SEQ_D,))
        reqs = [core.Request(category=cat, period=0.2, relative_deadline=0.4, n_frames=1)
                for _ in range(2)]
        for r in reqs:
            assert cluster.submit_request(r, external_arrivals=True)
        sched.ingest_frame(reqs[0], 0, payload=np.int32(5))
        sl.release(reqs[0].request_id)
        row_b = sl.leases[reqs[1].request_id][2][0]
        cluster.run()
        return int(np.asarray(sl.engine.arena(MID, SEQ_D).cur)[row_b]), \
            sched.metrics.completed_frames

    jout, tout = _both(run)
    assert tout == jout == (0, 1)


def test_shed_and_close_release_leases_like_jax():
    def run(core, ing, build, **kw):
        cluster, slices = _one_slice(core, build, **kw)
        # Frames are shed by hand; the shedder's own verdicts follow the
        # wall clock's device tail, so it is off.
        gw = ing.IngestGateway(cluster, shedding=False)
        cat = core.Category(MID, (SEQ_D,))
        shed = gw.register(ing.CameraSource(period=0.2, n_frames=4, payload_shape=(), seed=9),
                           cat, relative_deadline=0.4)
        sl = slices["s0"]
        sched = sl.scheduler
        gw._shed(shed, sched, cat)
        gw._shed(shed, sched, cat)
        shed.frames_ingested += 2
        for ev in sorted(shed._events)[:2]:
            cluster.loop.cancel(ev)
            shed._events.discard(ev)
        closed = gw.register(ing.CameraSource(period=0.2, n_frames=6, payload_shape=(),
                                              seed=10), cat, relative_deadline=0.4)
        cluster.loop.schedule(cluster.loop.now + 0.3, lambda: gw.close(closed))
        cluster.run()
        return (dict(sl.leases), sched.metrics.dropped_frames, closed.state,
                shed.conserved(), closed.conserved(), len(sl.engine.arena(MID, SEQ_D).free))

    jout, tout = _both(run)
    assert tout == jout == ({}, 2, "closed", True, True, 2)


def test_payload_decode_without_leases_is_refused():
    sched, engine, _ = build_live_scheduler({MID: tiny(MID)}, [(MID, (SEQ_D,), "decode")],
                                            batch_sizes=(1, 2), device="cpu", profile_runs=1)
    cat = P.Category(MID, (SEQ_D,))
    with pytest.raises(ValueError, match="cluster path"):
        PI.IngestGateway(sched).register(
            PI.CameraSource(period=0.2, n_frames=2, payload_shape=(), seed=0), cat,
            relative_deadline=0.4)
    f = Frame(request_id=0, category=cat, index=0, arrival_time=0.0, deadline=1.0,
              payload=np.int32(3))
    job = JobInstance(category=cat, frames=[f], release_time=0.0, relative_deadline=1.0,
                      shape_key=(SEQ_D,))
    with pytest.raises(RuntimeError, match="no arena leases"):
        sched.device.dispatch_fn(job)
    sched.device.close()


def test_leased_burst_fuses_into_chunks_bit_equal_to_single_steps():
    """A reconnecting client's backlog on a leased row, beside a camera
    stream through the gateway: the EDF worker fuses the burst into
    chunks on the slot-aware chunk path; each chunk step's row equals
    the twin engine's single step on the same token, bit for bit."""
    cluster, slices = tbuild({MID: tiny(MID)}, CATS, slice_names=("s0",),
                             batch_sizes=(1, 2, 4), profile_runs=2, nonrt_cap=1,
                             chunk_depth=4, device="cpu")
    sl = slices["s0"]
    captured = _spy(slices)
    gw = PI.IngestGateway(cluster, shedding=False)
    cat = P.Category(MID, (SEQ_D,))
    cam = gw.register(PI.CameraSource(period=0.2, n_frames=4, payload_shape=(), seed=3), cat,
                      relative_deadline=0.4)
    burst = P.Request(category=cat, period=0.5, relative_deadline=30.0, n_frames=8)
    assert cluster.submit_request(burst, external_arrivals=True)
    toks = np.random.default_rng(8).integers(0, 256, size=8).astype(np.int32)

    def backlog():
        now = cluster.loop.now
        for i, tok in enumerate(toks):
            sl.scheduler.metrics.record_ingest()
            f = Frame(request_id=burst.request_id, category=cat, index=i, arrival_time=now,
                      deadline=now + 30.0, payload=tok)
            sl.scheduler.worker.submit(JobInstance(category=cat, frames=[f], release_time=now,
                                                   relative_deadline=30.0,
                                                   shape_key=(SEQ_D,)))

    cluster.loop.schedule(cluster.loop.now + 0.1, backlog)
    cluster.run()
    chunks = [job.k for _, job, _ in captured["s0"] if isinstance(job, ChunkJob)]
    assert max(chunks) >= 2
    steps = stream_steps(captured["s0"], burst.request_id)
    assert [t for _, t, _ in steps] == toks.tolist()
    for (_, _, got), want in zip(steps, twin_replay(sl.engine, SEQ_D, steps)):
        assert torch.equal(got, want)
    agg = cluster.aggregate_metrics()
    assert agg["completed_frames"] + agg["dropped_frames"] + agg["lost_frames"] \
        == agg["ingested_frames"] == 12
    assert cam.conserved() and sl.leases == {}
    assert sl.engine.stats["decode_compiles"] == 0 and sl.engine.stats["chunk_steps"] >= 2
