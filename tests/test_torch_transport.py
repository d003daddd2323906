"""The port's datagram transport against the JAX package's, on the CPU.

Twins of ``tests/test_transport.py`` and ``tests/test_transport_lifecycle.py``:
the same seeded scenarios run through ``repro`` and ``repro_torch``
(``build_sim_cluster`` on the virtual ``EventLoop``, or a single DeepRT)
and must decide identically: every session's delivered log, delivered
bytes and wire legs (delivered / shed / late / lost / duplicate /
refused / evicted), the server's status snapshot and lifecycle counters,
the clients' credits, retransmits and retries, the links' fault counts,
the cluster's metrics and the telemetry span sequence ``(t, stage, rid,
idx, where, cat)``. Request ids are renumbered by first appearance (each
package counts requests with its own process-global counter). Each
scenario also keeps the reference test's own assertions on the port's
run.

Covered: the codec (bytes identical across packages, each decoding the
other's), the malformed corpus and a seeded fuzz with identical verdicts,
``LinkPlan.from_seed`` schedules, reassembly under drop / duplicate /
reorder / delay, flow control, re-homing, status snapshots, completion
faults, the hello gate, reassembly budgets, the session lifecycle,
cohort credit, bounded status, the sharded table, the chaos property and
the eviction-order property (hypothesis, across packages), the UDP
bindings on loopback, and ``build_live_transport`` over live tiny
clusters of both packages (the port's engines on the JAX engines'
parameters through ``interop``), a slice failed mid-stream.
"""
import json
import random
import socket
import struct
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import repro.ingest as JI
import repro.ingest.transport as JT
import repro_torch.ingest as PI
import repro_torch.ingest.transport as PT
from repro import core as J
from repro.configs.registry import tiny as jtiny
from repro.serving.batcher_bridge import build_live_transport as jbuild
from repro_torch import core as P
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.serving.batcher_bridge import build_live_transport as tbuild

JAXP = SimpleNamespace(name="jax", core=J, ing=JI, tr=JT)
TORCHP = SimpleNamespace(name="torch", core=P, ing=PI, tr=PT)
SHAPE = (4,)


class _Ids:
    """Request ids renumbered by first appearance."""

    def __init__(self):
        self.map = {}

    def __call__(self, rid):
        if rid is None or rid < 0:
            return rid
        return self.map.setdefault(rid, len(self.map))


def _table(pk, a=0.01, c=0.04):
    table = pk.core.ProfileTable()
    for b in (1, 2, 4, 8, 16, 32):
        table.record("m", SHAPE, b, a + c * b)
    return table


def _cat(pk):
    return pk.core.Category("m", SHAPE)


def _pipe(pk, names=("s0", "s1"), plan=None, flow=True, **server_kw):
    """A simulated cluster behind the gateway and the transport server,
    all traced, and one SimLink into the server."""
    loop = pk.core.EventLoop()
    cluster = pk.core.build_sim_cluster(lambda: _table(pk), list(names), loop=loop)
    tracer = pk.core.FrameTracer()
    cluster.attach_tracer(tracer)
    gateway = pk.ing.IngestGateway(cluster)
    server = pk.ing.TransportServer(gateway, flow_control=flow, record_payloads=True,
                                    **server_kw)
    gateway.tracer = tracer
    server.tracer = tracer
    link = pk.ing.SimLink(loop, server.datagram, plan=plan)
    return SimpleNamespace(pk=pk, loop=loop, target=cluster, server=server, link=link,
                           tracer=tracer, clients=[], links=[link], sources=[])


def _client(ctx, src, deadline, link=None, **kw):
    c = ctx.pk.ing.TransportSource(src, _cat(ctx.pk), deadline, link or ctx.link, **kw)
    ctx.clients.append(c)
    ctx.sources.append(src)
    return c


def _drain(ctx):
    ctx.loop.run()
    ctx.server.finalize_all()
    ctx.loop.run()


def _conserved(target) -> bool:
    if hasattr(target, "aggregate_metrics"):
        agg = target.aggregate_metrics()
        return (agg["completed_frames"] + agg["dropped_frames"] + agg["lost_frames"]
                == agg["ingested_frames"])
    m = target.metrics
    return m.completed_frames + m.dropped_frames + m.lost_frames == m.ingested_frames


def summary(ctx):
    """Everything the transport, its clients, links and target decided."""
    rid = _Ids()
    server = ctx.server
    status = server.status()
    tele = status.pop("telemetry", {})
    for key in ("tracer", "attribution"):
        tele.pop(key, None)
    for s in status.get("sessions", {}).values():
        s["request_id"] = rid(s["request_id"])
    out = {"status": json.dumps(status, sort_keys=True, default=str),
           "telemetry": json.dumps(tele, sort_keys=True, default=str)}
    out["sessions"] = {
        sid: dict(log=list(ts.delivered_log), seen=sorted(ts.seen),
                  payloads={k: np.asarray(v).tolist() for k, v in ts.delivered_payloads.items()},
                  finalized=ts.finalized, eviction=ts.eviction_reason, fin=ts.fin_total,
                  cohort=ts.cohort_downshifts, buffered=sorted(ts.buffer),
                  bytes=ts.buffered_bytes, last_credit=ts.last_credit_at,
                  state=ts.session.state, shed=ts.session.last_shed_reason,
                  conserved=ts.wire_conserved())
        for sid, ts in server.sessions.items()}
    out["server"] = dict(server.telemetry(), health_log=list(server.health_log),
                         cohort={k: sorted(v) for k, v in server._cohort.items()})
    out["clients"] = [(c.state, c.sid, c.frames_sent, c.retransmits, c.credits_seen,
                       c.downshifts_applied, c.rehomes_seen, c.hello_retries, c.duty)
                      for c in ctx.clients]
    out["links"] = [(l.sends, l.dropped, l.duplicated, l.reordered, l.delayed)
                    for l in ctx.links]
    target = ctx.target
    if hasattr(target, "slices"):
        out["aggregate"] = target.aggregate_metrics()
        out["placement"] = sorted((rid(r), n) for r, n in target.placement.items())
        out["failover"] = sorted((rid(r), rid(t)) for r, t in target.failover_map.items())
        out["parked"] = ([rid(r) for r in target.parked_admitted],
                         [rid(r) for r in target.parked_expired])
        out["transitions"] = list(target.health.transitions)
        slices = {n: sl.scheduler for n, sl in target.slices.items()}
    else:
        slices = {"solo": target}
    for name, sched in slices.items():
        m = sched.metrics
        out[f"metrics {name}"] = (
            m.completed_frames, m.missed_frames, m.dropped_frames, m.lost_frames,
            m.delivered_frames, m.ingested_frames, m.duplicate_completions, m.job_count,
            sorted((rid(r), i, v) for (r, i), v in m.frame_records.items()),
            list(m.frame_latencies))
    out["spans"] = [(ev.t, ev.stage, rid(ev.rid), ev.idx, ev.where, ev.cat)
                    for ev in ctx.tracer.ring] if ctx.tracer is not None else None
    return out


def twin(scenario, *args, **kw):
    """Run ``scenario`` in both packages; their summaries must agree.
    Returns the port's run."""
    want = summary(scenario(JAXP, *args, **kw))
    ctx = scenario(TORCHP, *args, **kw)
    got = summary(ctx)
    for key in want:
        assert got[key] == want[key], key
    assert set(got) == set(want)
    return ctx


def _sources_payloads_match(ctx, i=0, sid=1):
    ts = ctx.server.sessions[sid]
    for seq, payload in ts.delivered_payloads.items():
        assert np.array_equal(payload, ctx.sources[i].payload(seq))


# ---------------------------------------------------------------------------
# Wire codec and the adversarial corpus
# ---------------------------------------------------------------------------
def test_codec_bytes_identical_and_cross_decoded():
    payloads = [np.arange(12, dtype=np.int32).reshape(3, 4) - 5, np.int32(9),
                np.zeros((0,), np.int32), np.arange(7, dtype=np.int32)]
    for i, payload in enumerate(payloads):
        a = JT.encode_data(7, 42 + i, 1.25, payload)
        b = PT.encode_data(7, 42 + i, 1.25, payload)
        assert a == b
        for dec in (JT.decode, PT.decode):
            mtype, msg = dec(a)
            assert mtype == JT.DATA == PT.DATA
            assert (msg.session_id, msg.seq, msg.sent_at) == (7, 42 + i, 1.25)
            assert msg.payload.dtype == np.int32
            assert np.array_equal(msg.payload, np.asarray(payload))
    for mtype, body in ((JT.FIN, {"sid": 3, "total": 17}), (JT.HELLO_RETRY, {"backoff": 0.2}),
                        (JT.CREDIT, {"sid": 1, "duty": 0.5})):
        a, b = JT.encode_control(mtype, body), PT.encode_control(mtype, body)
        assert a == b and JT.decode(b) == PT.decode(a) == (mtype, body)
    names = ("MAGIC", "MALFORMED", "HELLO", "HELLO_ACK", "DATA", "FIN", "CREDIT", "REHOME",
             "STATUS", "STATUS_REPLY", "HELLO_RETRY", "MAX_NDIM", "MAX_DIM", "DROP",
             "DUPLICATE", "REORDER", "LINK_DELAY", "LINK_FAULT_KINDS")
    assert {n: getattr(PT, n) for n in names} == {n: getattr(JT, n) for n in names}


def _corpus():
    M, D = JT.MAGIC, bytes([JT.DATA])
    head = lambda ndim, sent=0.0: M + D + struct.pack("!IIdB", 1, 0, sent, ndim)
    return [
        b"", b"DRT", b"NOPE" + bytes(16), M + bytes([200]), M + D + b"\x00" * 4,
        head(JT.MAX_NDIM + 1), head(2), head(1) + struct.pack("!I", JT.MAX_DIM + 1),
        head(2) + struct.pack("!II", 1 << 20, 1 << 10), head(1) + struct.pack("!I", 4) + bytes(8),
        head(1, float("nan")) + struct.pack("!I", 1) + bytes(4),
        M + bytes([JT.FIN]) + b"{not json", M + bytes([JT.FIN]) + b'"a list?"',
    ]


def test_malformed_corpus_and_fuzz_verdicts_match_jax():
    blobs = _corpus()
    rng = np.random.default_rng(7)
    valid = JT.encode_data(1, 2, 0.5, np.arange(6, dtype=np.int32))
    blobs += [valid[:cut] for cut in range(len(valid) + 1)]
    blobs += [bytes(rng.integers(0, 256, size=int(rng.integers(0, 64)), dtype=np.uint8))
              for _ in range(300)]
    blobs += [JT.MAGIC + bytes(rng.integers(0, 256, size=int(rng.integers(0, 40)),
                                            dtype=np.uint8)) for _ in range(300)]
    for blob in blobs:
        want, got = JT.decode(blob), PT.decode(blob)
        assert got[0] == want[0], blob
        if want[0] == JT.MALFORMED:
            assert got[1] == want[1] and isinstance(got[1], str) and got[1]
    verdicts = [PT.decode(b)[1] for b in _corpus()]
    assert verdicts == [
        "truncated_header", "truncated_header", "bad_magic", "unknown_type",
        "truncated_data_head", "ndim_overflow", "truncated_dims", "dim_overflow",
        "oversized_payload", "payload_size_mismatch", "bad_sent_at", "bad_control_json",
        "bad_control_json"]


def scenario_server_counts_malformed(pk):
    ctx = _pipe(pk)
    ctx.server.datagram(b"\x01")
    ctx.server.datagram(pk.tr.MAGIC + bytes([200]))
    ctx.server.datagram(pk.tr.encode_control(pk.tr.FIN, {"wrong": 1}))
    return ctx


def test_server_counts_malformed_like_jax():
    ctx = twin(scenario_server_counts_malformed)
    assert ctx.server.malformed == 3
    assert ctx.server.malformed_by_reason == {
        "truncated_header": 1, "unknown_type": 1, "bad_fin_body": 1}


# ---------------------------------------------------------------------------
# LinkPlan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n,kw", [
    (9, 200, dict(p_drop=0.1, p_dup=0.1, p_reorder=0.2, p_delay=0.2)),
    (4, 500, dict(p_drop=0.15, p_dup=0.15, p_reorder=0.15, p_delay=0.15)),
    (2026, 64, dict(p_drop=0.06, p_dup=0.06, p_reorder=0.08, p_delay=0.06,
                    reorder_hold=(0.05, 0.2))),
    (21, 60, dict(p_drop=0.08, p_dup=0.08, p_reorder=0.1, reorder_hold=(0.1, 0.5))),
])
def test_link_plan_from_seed_matches_jax(seed, n, kw):
    want = JT.LinkPlan.from_seed(seed, n, **kw)
    got = PT.LinkPlan.from_seed(seed, n, **kw)
    spec = lambda s: (s.kind, s.at_send, s.delay, s.copies)
    assert [spec(s) for s in got.specs] == [spec(s) for s in want.specs]
    assert [got.arrivals(i) for i in range(n + 5)] == [want.arrivals(i) for i in range(n + 5)]
    short = PT.LinkPlan.from_seed(seed, n // 4, **kw)
    for i in range(n // 4):  # prefix-stable
        a, b = short.for_send(i), got.for_send(i)
        assert (a is None) == (b is None) and (a is None or spec(a) == spec(b))


def test_link_plan_refusals_match_jax():
    for tr in (JT, PT):
        plan = tr.LinkPlan((tr.LinkFault(tr.DROP, 0), tr.LinkFault(tr.DUPLICATE, 1, copies=3),
                            tr.LinkFault(tr.REORDER, 2, delay=0.5),
                            tr.LinkFault(tr.LINK_DELAY, 3, delay=0.01)))
        assert [plan.arrivals(i) for i in range(5)] == [[], [0.0] * 3, [0.5], [0.01], [0.0]]
        for bad in (lambda: tr.LinkFault("gremlin", 0),
                    lambda: tr.LinkFault(tr.REORDER, 0, delay=0.0),
                    lambda: tr.LinkFault(tr.DUPLICATE, 0, copies=1),
                    lambda: tr.LinkPlan((tr.LinkFault(tr.DROP, 2), tr.LinkFault(tr.DROP, 2))),
                    lambda: tr.LinkPlan.from_seed(0, 10, p_drop=0.6, p_dup=0.6)):
            with pytest.raises(ValueError):
                bad()


# ---------------------------------------------------------------------------
# Reassembly over a chaotic link, flow control, re-homing, status
# ---------------------------------------------------------------------------
def _faults(pk, *specs):
    return pk.ing.LinkPlan(tuple(pk.ing.LinkFault(getattr(pk.tr, kind), at, **kw)
                                 for kind, at, kw in specs))


def scenario_reassembly(pk, specs, n_frames=24, period=0.5, deadline=2.0, **server_kw):
    ctx = _pipe(pk, plan=_faults(pk, *specs) if specs else None, **server_kw)
    src = pk.ing.PeriodicSource(period=period, n_frames=n_frames, payload_shape=SHAPE, seed=7)
    assert _client(ctx, src, deadline).start(ctx.server)
    _drain(ctx)
    return ctx


REASSEMBLY = {
    "lossless": ((), dict(n_frames=16)),
    "duplicates": ((("DUPLICATE", 2, dict(copies=4)), ("DUPLICATE", 5, dict(copies=2))),
                   dict(n_frames=10)),
    "drops": ((("DROP", 3, {}), ("DROP", 8, {})), dict(n_frames=12)),
    "reorder-held": ((("REORDER", 4, dict(delay=0.6)),), dict(n_frames=12)),
    "reorder-window-overflow": ((("REORDER", 1, dict(delay=30.0)),),
                                dict(n_frames=10, reorder_window=2, reorder_timeout=0.9)),
    "late-rejected": ((("LINK_DELAY", 2, dict(delay=6.0)),),
                      dict(n_frames=8, deadline=2.0, reorder_timeout=8.0)),
    "delay-within-budget": ((("LINK_DELAY", 0, dict(delay=0.2)),), dict(n_frames=4)),
}


@pytest.mark.parametrize("name", list(REASSEMBLY))
def test_reassembly_matches_jax(name):
    specs, kw = REASSEMBLY[name]
    ctx = twin(scenario_reassembly, specs, **kw)
    ts = ctx.server.sessions[1]
    assert _conserved(ctx.target) and ts.wire_conserved()
    assert ts.delivered_log == sorted(set(ts.delivered_log))
    _sources_payloads_match(ctx)
    if name == "lossless":
        assert ts.delivered_log == list(range(16)) and ts.net_lost == ts.duplicates == 0
    elif name == "duplicates":
        assert ts.delivered == 10 and ts.duplicates == 4
    elif name == "drops":
        assert ts.delivered == 10 and ts.net_lost == 2 and ts.session.frames_lost == 2
    elif name == "reorder-held":
        assert ts.delivered_log == list(range(12))
    elif name == "reorder-window-overflow":
        assert 1 not in ts.delivered_log and ts.net_lost >= 1
    elif name == "late-rejected":
        assert ts.late_rejected == 1 and ts.session.last_shed_reason.startswith("late")
    else:
        sl = ctx.target.slices[ts.session.slice_name]
        records = sl.scheduler.metrics.frame_records
        assert records and all(abs(dl - (arr + 2.0)) < 1e-9
                               for arr, dl, _c in records.values())


def scenario_flow(pk, flow):
    ctx = _pipe(pk, names=("s0",), flow=flow)
    src = pk.ing.BurstSource(period=0.12, n_frames=120, payload_shape=SHAPE, seed=3,
                             burst=8, duty=0.4)
    assert _client(ctx, src, 0.36, flow_control=flow).start(ctx.server)
    _drain(ctx)
    return ctx


def _effective_miss(ctx):
    m = ctx.target.slices["s0"].scheduler.metrics
    return (m.missed_frames + m.dropped_frames + m.lost_frames) / m.ingested_frames


def test_flow_control_matches_jax_and_beats_the_control_arm():
    on, off = twin(scenario_flow, True), twin(scenario_flow, False)
    assert _effective_miss(on) < _effective_miss(off)
    c_on, c_off = on.clients[0], off.clients[0]
    assert c_on.downshifts_applied > 0 and c_on.duty > c_on.plan_duty
    assert c_off.duty == c_off.plan_duty and c_off.credits_seen == 0
    s = on.server.sessions[1].session
    assert s.downshifts > 0 and s.credit < 1.0 and "over_budget" in s.last_downshift_reason


def scenario_rehome(pk, fail_at=7.0, n_frames=30, chaos_seed=None, names=("s0", "s1")):
    plan = None
    if chaos_seed is not None:
        plan = pk.ing.LinkPlan.from_seed(chaos_seed, 60, p_drop=0.08, p_dup=0.08,
                                         p_reorder=0.1, reorder_hold=(0.1, 0.5))
    ctx = _pipe(pk, plan=plan, names=names)
    src = pk.ing.PeriodicSource(period=0.5, n_frames=n_frames, payload_shape=SHAPE, seed=11)
    assert _client(ctx, src, 2.0).start(ctx.server)
    home = ctx.server.sessions[1].session.slice_name
    ctx.home = home
    ctx.loop.schedule(fail_at, lambda: ctx.target.fail_slice(home), priority=0)
    _drain(ctx)
    return ctx


def test_rehoming_matches_jax_with_real_bytes():
    ctx = twin(scenario_rehome)
    ts = ctx.server.sessions[1]
    assert ts.rehomes == 1 and ts.session.slice_name != ctx.home
    assert ctx.clients[0].rehomes_seen == 1
    post = [s for s in ts.delivered_log if s >= 15]
    assert post and all(ts.delivered_payloads[s].any() for s in post)
    _sources_payloads_match(ctx)
    new_slice = ctx.target.slices[ts.session.slice_name]
    tail = [f for job in new_slice.scheduler.worker.completed_jobs for f in job.frames
            if f.request_id == ts.session.request_id]
    assert tail and all(f.payload is not None and np.asarray(f.payload).any() for f in tail)
    assert _conserved(ctx.target) and ts.wire_conserved()


def test_rehome_under_chaos_and_with_no_survivor_match_jax():
    ctx = twin(scenario_rehome, 7.0, 30, 21)
    ts = ctx.server.sessions[1]
    assert ts.rehomes == 1 and ts.delivered_log == sorted(set(ts.delivered_log))
    _sources_payloads_match(ctx)
    ctx = twin(scenario_rehome, 4.0, 20, None, ("s0",))
    ts = ctx.server.sessions[1]
    assert ts.session.state == "closed" and ts.rehomes == 0 and ts.wire_conserved()


def test_status_snapshot_matches_jax():
    ctx = twin(scenario_rehome, 2.2, 10)
    snap = json.loads(ctx.server.status_json())
    sess = snap["sessions"]["1"]
    assert set(snap["slices"]) == {"s0", "s1"} and sess["wire"]["conserved"] is True
    assert sess["rehomes"] == 1
    assert sess["gateway"]["ingested"] == (sess["wire"]["delivered"] + sess["wire"]["shed"]
                                           + sess["wire"]["late_rejected"]
                                           + sess["wire"]["lost_to_slice"])
    assert any(t["slice"] == ctx.home and t["new"] == "quarantined"
               for t in snap["health_transitions"])
    assert snap["slices"][ctx.home]["alive"] is False


# ---------------------------------------------------------------------------
# Device-side completion faults
# ---------------------------------------------------------------------------
def _completion_run(pk, plan_fn, n_frames=12):
    loop = pk.core.EventLoop()
    device = pk.core.FaultyDevice(pk.core.SequentialDevice(loop), plan_fn(pk.core))
    sched = pk.core.DeepRT(_table(pk), device=device, loop=loop)
    req = pk.core.Request(category=_cat(pk), period=0.5, relative_deadline=1.5,
                          n_frames=n_frames, start_time=0.0)
    assert sched.submit_request(req).admitted
    loop.run()
    m = sched.metrics
    return (m.completed_frames, m.dropped_frames, m.lost_frames, m.ingested_frames,
            m.duplicate_completions, list(m.frame_latencies), device.injected)


@pytest.mark.parametrize("name,plan_fn,n_frames", [
    ("duplicate", lambda c: c.FaultPlan((c.FaultSpec(c.DUP_COMPLETE, 1),)), 12),
    ("reordered", lambda c: c.FaultPlan((c.FaultSpec(c.REORDER_COMPLETE, 3, factor=6.0),)), 12),
    ("mixed", lambda c: c.FaultPlan.from_seed(13, 64, p_dup_complete=0.2,
                                              p_reorder_complete=0.2), 40),
])
def test_completion_faults_match_jax(name, plan_fn, n_frames):
    want = _completion_run(JAXP, plan_fn, n_frames)
    got = _completion_run(TORCHP, plan_fn, n_frames)
    assert got == want
    completed, dropped, lost, ingested, dups = got[:5]
    assert completed == n_frames and completed + dropped + lost == ingested
    if name == "duplicate":
        assert dups == 1
    elif name == "reordered":
        assert dups == 0
    else:
        assert dups >= 1


def test_completion_fault_plans_match_jax():
    a = P.FaultPlan.from_seed(3, 400, p_dup_complete=0.25, p_reorder_complete=0.25)
    b = J.FaultPlan.from_seed(3, 400, p_dup_complete=0.25, p_reorder_complete=0.25)
    spec = lambda s: (s.kind, s.at_submit, s.factor, s.extra)
    assert [spec(s) for s in a.specs] == [spec(s) for s in b.specs]
    assert {s.kind for s in a.specs} >= {P.DUP_COMPLETE, P.REORDER_COMPLETE}
    with pytest.raises(ValueError):
        P.FaultSpec(P.REORDER_COMPLETE, 0, factor=1.0, extra=0.0)


# ---------------------------------------------------------------------------
# Hello gate, budgets, lifecycle, cohort credit, bounded status
# ---------------------------------------------------------------------------
def _periodic(pk, period, n, seed=0):
    return pk.ing.PeriodicSource(period=period, n_frames=n, payload_shape=SHAPE, seed=seed)


def scenario_hello_storm(pk):
    ctx = _pipe(pk, hello_rate=2.0, hello_burst=2.0)
    for i in range(6):
        assert _client(ctx, _periodic(pk, 0.5, 3, seed=i), 2.0).start(ctx.server)
    ctx.accepted_at_once = ctx.server.hellos_accepted
    _drain(ctx)
    return ctx


def scenario_retry_exhaustion(pk):
    ctx = _pipe(pk, max_sessions=1)
    assert _client(ctx, _periodic(pk, 1.0, 10), 5.0).start(ctx.server)
    assert _client(ctx, _periodic(pk, 0.5, 2), 2.0, hello_max_retries=2).start(ctx.server)
    ctx.loop.run()
    return ctx


def scenario_max_sessions(pk):
    ctx = _pipe(pk, max_sessions=1, idle_timeout=5.0)
    assert _client(ctx, _periodic(pk, 0.1, 2), 0.5).start(ctx.server)
    assert _client(ctx, _periodic(pk, 0.1, 2), 0.5, hello_max_retries=50).start(ctx.server)
    ctx.open_at_once = ctx.server.open_count
    ctx.loop.run()
    return ctx


def scenario_draining(pk):
    ctx = _pipe(pk)
    ctx.server.drain(grace=0.0)
    assert not _client(ctx, _periodic(pk, 0.1, 2), 0.5).start(ctx.server)
    ctx.loop.run()
    return ctx


def scenario_bad_hello(pk):
    ctx = _pipe(pk)
    ctx.replies = [pk.tr.decode(ctx.server.hello({"model_id": "m"})),
                   pk.tr.decode(ctx.server.hello(
                       {"model_id": "m", "shape_key": [4], "period": -1.0, "n_frames": 5,
                        "relative_deadline": 0.5}))]
    return ctx


def test_hello_gate_matches_jax():
    ctx = twin(scenario_hello_storm)
    assert ctx.accepted_at_once == 2 and ctx.server.hellos_accepted == 6
    assert sum(c.hello_retries for c in ctx.clients) >= 4
    ctx = twin(scenario_retry_exhaustion)
    assert ctx.clients[1].state == "rejected" and ctx.clients[1].hello_retries == 3
    ctx = twin(scenario_max_sessions)
    assert ctx.open_at_once == 1 and ctx.clients[1].state == "done"
    ctx = twin(scenario_draining)
    assert ctx.clients[0].state == "rejected" and ctx.server.hello_refused_draining == 1
    assert ctx.server.drained
    ctx = twin(scenario_bad_hello)
    assert ctx.replies[0][0] == PT.HELLO_ACK and not ctx.replies[0][1]["accepted"]
    assert ctx.server.malformed_by_reason.get("bad_hello_body") == 2


def scenario_session_budget(pk):
    ctx = _pipe(pk, session_buffer_bytes=40, reorder_window=64)
    assert ctx.server.open_session(category=_cat(pk), period=1.0, n_frames=4,
                                   relative_deadline=10.0)[1]
    pay = np.arange(4, dtype=np.int32)
    for seq in (1, 2, 3):
        ctx.server.datagram(pk.tr.encode_data(1, seq, ctx.loop.now, pay))
    ctx.mid = (len(ctx.server.sessions[1].buffer), ctx.server.sessions[1].refused)
    ctx.server.datagram(pk.tr.encode_data(1, 0, ctx.loop.now, pay))
    _drain(ctx)
    return ctx


def scenario_global_budget(pk):
    ctx = _pipe(pk, reassembly_budget_bytes=48, reorder_window=64)
    for _ in range(2):
        assert ctx.server.open_session(category=_cat(pk), period=1.0, n_frames=4,
                                       relative_deadline=10.0)[1]
    pay = np.arange(4, dtype=np.int32)
    for sid, seq in ((1, 1), (1, 2), (2, 1), (2, 2)):
        ctx.server.datagram(pk.tr.encode_data(sid, seq, ctx.loop.now, pay))
    ctx.mid = (ctx.server.reassembly_bytes, ctx.server.budget_refusals)
    for sid in (1, 2):
        ctx.server.datagram(pk.tr.encode_data(sid, 0, ctx.loop.now, pay))
    _drain(ctx)
    return ctx


def test_reassembly_budgets_match_jax():
    ctx = twin(scenario_session_budget)
    assert ctx.mid == (2, 1) and ctx.server.sessions[1].delivered == 3
    assert ctx.server.reassembly_bytes == 0 and _conserved(ctx.target)
    ctx = twin(scenario_global_budget)
    assert ctx.mid == (48, 1) and ctx.server.sessions[2].refused == 1
    assert ctx.server.reassembly_bytes == 0
    assert all(ts.wire_conserved() for ts in ctx.server.sessions.values())


def scenario_zombie(pk):
    ctx = _pipe(pk, idle_timeout=1.0)
    assert _client(ctx, _periodic(pk, 0.1, 20), 0.5, abort_after=4).start(ctx.server)
    assert _client(ctx, _periodic(pk, 0.1, 10), 0.5).start(ctx.server)
    ctx.loop.run()
    return ctx


def scenario_slowloris(pk):
    ctx = _pipe(pk, idle_timeout=0.5)
    assert _client(ctx, _periodic(pk, 10.0, 100), 0.4, abort_after=2).start(ctx.server)
    ctx.loop.run()
    return ctx


def scenario_evicted_buffer(pk):
    ctx = _pipe(pk, idle_timeout=0.5, reorder_window=64, reorder_timeout=100.0)
    link2 = pk.ing.SimLink(ctx.loop, ctx.server.datagram)
    ctx.links.append(link2)
    client = _client(ctx, _periodic(pk, 1.0, 6), 200.0, link=link2)
    assert client.start(ctx.server)
    pay = np.arange(4, dtype=np.int32)
    ctx.server.datagram(pk.tr.encode_data(1, 1, ctx.loop.now, pay))
    ctx.server.datagram(pk.tr.encode_data(1, 2, ctx.loop.now, pay))
    client.state = "aborted"
    ctx.loop.run()
    return ctx


def scenario_retire(pk):
    ctx = _pipe(pk, retain_finalized=False)
    assert _client(ctx, _periodic(pk, 0.1, 5), 0.5).start(ctx.server)
    _drain(ctx)
    return ctx


def scenario_drain(pk):
    ctx = _pipe(pk)
    for _ in range(3):
        assert _client(ctx, _periodic(pk, 0.2, 8), 0.8).start(ctx.server)
    ctx.loop.schedule(0.7, lambda: ctx.server.drain(), priority=0)
    ctx.loop.run()
    return ctx


def _leases_empty(cluster):
    return all(len(sl.leases) == 0 for sl in cluster.slices.values())


def test_session_lifecycle_matches_jax():
    ctx = twin(scenario_zombie)
    zts, lts = ctx.server.sessions[1], ctx.server.sessions[2]
    assert ctx.clients[0].state == "aborted" and zts.eviction_reason == "zombie_idle"
    assert zts.session.state == "closed" and lts.delivered == 10
    assert _leases_empty(ctx.target) and _conserved(ctx.target)
    ctx.server.assert_conserved()
    ctx = twin(scenario_slowloris)
    assert ctx.server.sessions[1].eviction_reason == "zombie_idle"
    assert _leases_empty(ctx.target) and _conserved(ctx.target)
    ctx = twin(scenario_evicted_buffer)
    ts = ctx.server.sessions[1]
    assert ts.finalized and ts.evicted == 2 and not ts.buffer
    assert ctx.server.reassembly_bytes == 0 and ts.wire_conserved()
    ctx = twin(scenario_retire)
    assert len(ctx.server.sessions) == 0 and ctx.server.retired_sessions == 1
    assert ctx.server.retired_totals["delivered"] == 5
    ctx.server.assert_conserved()
    ctx = twin(scenario_drain)
    assert ctx.server.drained and all(ts.finalized for ts in ctx.server.sessions.values())
    assert _leases_empty(ctx.target)
    ctx.server.assert_conserved()


def scenario_cohort(pk, burst):
    ctx = _pipe(pk, names=("s0",))
    if burst:
        for i in range(3):
            src = pk.ing.BurstSource(period=0.4, n_frames=20, burst=4, duty=0.4,
                                     payload_shape=SHAPE, seed=i)
            assert _client(ctx, src, 2.0).start(ctx.server)
        ctx.cohort_at_start = sorted(ctx.server._cohort["s0"])
    else:
        assert _client(ctx, _periodic(pk, 0.2, 10), 1.0).start(ctx.server)
    ctx.loop.schedule(0.5 if burst else 0.3, lambda: ctx.target.health._set_state(
        "s0", pk.core.SUSPECT, "forced degradation (test)"), priority=0)
    _drain(ctx)
    return ctx


def test_cohort_credit_matches_jax():
    ctx = twin(scenario_cohort, True)
    assert ctx.cohort_at_start == [1, 2, 3] and ctx.server.cohort_signals == 3
    for sid in (1, 2, 3):
        ts = ctx.server.sessions[sid]
        assert ts.cohort_downshifts >= 1
        assert "cohort: slice s0 degraded" in (ts.session.last_downshift_reason or "")
    assert all(c.credits_seen >= 1 for c in ctx.clients)
    ctx = twin(scenario_cohort, False)
    assert ctx.server.cohort_signals == 0 and ctx.clients[0].credits_seen == 0


def scenario_ten_sessions(pk):
    ctx = _pipe(pk)
    for _ in range(10):
        assert _client(ctx, _periodic(pk, 1.0, 4), 2.0).start(ctx.server)
    _drain(ctx)
    return ctx


def test_bounded_status_matches_jax():
    ctx = twin(scenario_ten_sessions)
    jctx = scenario_ten_sessions(JAXP)
    summ = ctx.server.status(summary=True, top_k=3)
    jsumm = jctx.server.status(summary=True, top_k=3)
    for s in (summ, jsumm):
        s.pop("telemetry")
    assert summ == jsumm
    ss = summ["session_summary"]
    assert ss["count"] == 10 and ss["wire_totals"]["delivered"] == 40
    assert ss["conservation_violations"] == 0 and len(ss["worst"]) <= 3
    assert "sessions" not in summ and summ["transport"]["sessions"] == 10

    class _Stub:
        state = "closed"
        slice_name = None

    assert "sessions" in json.loads(ctx.server.status_json())
    for sid in range(11, 70):
        ctx.server.sessions[sid] = PT.TransportSession(
            sid=sid, session=_Stub(), n_frames=1, relative_deadline=1.0, plan_duty=1.0,
            duty=1.0, finalized=True)
    body = json.loads(ctx.server.status_json())
    assert "session_summary" in body and "sessions" not in body


@pytest.mark.parametrize("shards", [1, 4, 5, 16])
def test_sharded_table_matches_jax(shards):
    tables = [tr._ShardedSessionTable(shards) for tr in (JT, PT)]
    ops = random.Random(shards)
    for _ in range(200):
        sid = ops.randrange(60)
        op = ops.choice(("set", "set", "del", "pop", "get"))
        results = []
        for t in tables:
            if op == "set":
                t[sid] = f"s{sid}"
                results.append(None)
            elif op == "del":
                results.append(sid in t and (t.__delitem__(sid) or True))
            elif op == "pop":
                results.append(t.pop(sid, "gone"))
            else:
                results.append(t.get(sid))
        assert results[0] == results[1]
    j, p = tables
    assert p.n_shards == j.n_shards and list(p.items()) == list(j.items())
    assert [dict(p.shard(i)) for i in range(p.n_shards)] == [
        dict(j.shard(i)) for i in range(j.n_shards)]
    with pytest.raises(KeyError):
        p.pop(10_000)


# ---------------------------------------------------------------------------
# Properties across packages: link chaos, eviction order
# ---------------------------------------------------------------------------
def scenario_chaos(pk, seed, p_drop, p_dup, p_reorder, p_delay, fail):
    ctx = _pipe(pk)
    ctx.link.plan = pk.ing.LinkPlan.from_seed(
        seed, 80, p_drop=p_drop, p_dup=p_dup, p_reorder=p_reorder, p_delay=p_delay,
        reorder_hold=(0.1, 0.6))
    src = pk.ing.PeriodicSource(period=0.5, n_frames=24, payload_shape=SHAPE, seed=seed)
    assert _client(ctx, src, 2.0).start(ctx.server)
    if fail:
        home = ctx.server.sessions[1].session.slice_name
        ctx.loop.schedule(5.0, lambda: ctx.target.fail_slice(home), priority=0)
    _drain(ctx)
    return ctx


def _chaos_twin(*args):
    ctx = twin(scenario_chaos, *args)
    ts = ctx.server.sessions[1]
    assert ts.delivered_log == sorted(set(ts.delivered_log))
    _sources_payloads_match(ctx)
    assert _conserved(ctx.target) and ts.wire_conserved()
    assert ts.finalized or ts.session.state in ("closed", "failover")


@pytest.mark.parametrize("seed,fail", [(0, False), (17, True), (91, True)])
def test_chaos_run_matches_jax(seed, fail):
    _chaos_twin(seed, 0.12, 0.1, 0.15, 0.1, fail)


def test_chaos_property_matches_jax():
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=8, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(0, 10_000), p_drop=st.floats(0.0, 0.2),
           p_dup=st.floats(0.0, 0.2), p_reorder=st.floats(0.0, 0.2),
           p_delay=st.floats(0.0, 0.2), fail=st.booleans())
    def prop(seed, p_drop, p_dup, p_reorder, p_delay, fail):
        _chaos_twin(seed, p_drop, p_dup, p_reorder, p_delay, fail)

    prop()


def scenario_churn(pk, seed):
    """Normal / zombie / slowloris sessions over chaotic wires, with
    fail_slice, garbage datagrams and drain at seed-chosen instants."""
    rng = random.Random(seed)
    ctx = _pipe(pk, names=("s0", "s1", "s2"), idle_timeout=1.0, session_buffer_bytes=64,
                reassembly_budget_bytes=512)
    for i in range(8):
        kind = rng.choice(("normal", "normal", "zombie", "slowloris"))
        period = 10.0 if kind == "slowloris" else 0.1
        abort_after = rng.randint(1, 4) if kind == "zombie" else (
            2 if kind == "slowloris" else None)
        plan = pk.ing.LinkPlan.from_seed(seed * 31 + i, 40, p_drop=0.1, p_dup=0.1,
                                         p_reorder=0.2, p_delay=0.1, reorder_hold=(0.05, 0.3))
        link = pk.ing.SimLink(ctx.loop, ctx.server.datagram, plan=plan)
        ctx.links.append(link)
        src = pk.ing.PeriodicSource(period=period, n_frames=rng.randint(4, 12),
                                    payload_shape=SHAPE, seed=i)
        _client(ctx, src, 0.6, link=link, abort_after=abort_after).start(
            ctx.server, start_in=rng.uniform(0.0, 0.3))
    for _ in range(5):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
        ctx.loop.schedule(rng.uniform(0.0, 1.0), lambda b=blob: ctx.server.datagram(b),
                          priority=0)
    if rng.random() < 0.7:
        victim = rng.choice(("s0", "s1", "s2"))
        ctx.loop.schedule(rng.uniform(0.2, 1.0), lambda v=victim: ctx.target.fail_slice(v),
                          priority=0)
    ctx.loop.schedule(rng.uniform(1.0, 3.0), lambda: ctx.server.drain(), priority=0)
    _drain(ctx)
    return ctx


def _churn_twin(seed):
    ctx = twin(scenario_churn, seed)
    assert ctx.server.drained
    for ts in ctx.server.sessions.values():
        assert ts.finalized or ts.session.state in ("closed", "rejected")
        assert ts.wire_conserved()
    assert _conserved(ctx.target) and _leases_empty(ctx.target)
    assert not ctx.target.parked
    ctx.server.assert_conserved()


@pytest.mark.parametrize("seed", [0, 7, 23, 61, 104])
def test_eviction_order_matches_jax(seed):
    _churn_twin(seed)


def test_eviction_order_property_matches_jax():
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=6, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(0, 100_000))
    def prop(seed):
        _churn_twin(seed)

    prop()


# ---------------------------------------------------------------------------
# UDP bindings on loopback (WallClock)
# ---------------------------------------------------------------------------
def _udp_run(pk, garbage=False):
    """One 8-frame stream through UdpClientLink -> UdpServerBinding on
    127.0.0.1, the HELLO/HELLO_ACK handshake first; optionally garbage
    datagrams sprayed at the server mid-stream."""
    loop = pk.core.WallClock()
    sched = pk.core.DeepRT(_table(pk, 0.001, 0.002), device=pk.core.SequentialDevice(loop),
                           loop=loop)
    server = pk.ing.TransportServer(pk.ing.IngestGateway(sched), record_payloads=True)
    binding = pk.ing.UdpServerBinding(server).start()
    link = pk.ing.UdpClientLink(loop, binding.addr)
    attacker = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    loop.hold()
    runner = threading.Thread(target=loop.run, daemon=True)
    runner.start()
    try:
        src = pk.ing.PeriodicSource(period=0.02, n_frames=8, payload_shape=SHAPE, seed=9)
        client = pk.ing.TransportSource(src, _cat(pk), 1.0, link)
        sid, ok = link.handshake(client)
        assert ok and sid == 1
        client.start_remote(sid)
        if garbage:
            time.sleep(0.05)
            for blob in (b"\x00", b"NOPE" + bytes(32),
                         pk.tr.MAGIC + bytes([pk.tr.DATA])
                         + struct.pack("!IIdB", sid, 0, 0.0, 255),
                         pk.tr.MAGIC + bytes([pk.tr.HELLO]) + b"{broken"):
                attacker.sendto(blob, binding.addr)
        deadline = time.time() + 10.0
        while time.time() < deadline:
            ts = server.sessions.get(sid)
            if ts is not None and len(ts.seen) >= 8:
                break
            time.sleep(0.02)
        loop.post(server.finalize_all)
        while time.time() < deadline and not server.sessions[sid].finalized:
            time.sleep(0.02)
        while garbage and time.time() < deadline and server.malformed < 4:
            time.sleep(0.02)
        ts = server.sessions[sid]
        alive = binding._thread.is_alive()
        m = sched.metrics
        return dict(finalized=ts.finalized, delivered=ts.delivered, log=list(ts.delivered_log),
                    payloads={k: v.tolist() for k, v in ts.delivered_payloads.items()},
                    conserved=ts.wire_conserved(), alive=alive,
                    malformed=dict(server.malformed_by_reason),
                    identity=m.completed_frames + m.dropped_frames + m.lost_frames
                    == m.ingested_frames,
                    bytes_ok=all(np.array_equal(v, src.payload(k))
                                 for k, v in ts.delivered_payloads.items()))
    finally:
        attacker.close()
        link.close()
        binding.close()
        loop.release()
        runner.join(timeout=2.0)


@pytest.mark.parametrize("garbage", [False, True])
def test_udp_binding_over_loopback_matches_jax(garbage):
    want, got = _udp_run(JAXP, garbage), _udp_run(TORCHP, garbage)
    assert got == want
    assert got["finalized"] and got["delivered"] == 8 and got["log"] == list(range(8))
    assert got["conserved"] and got["identity"] and got["bytes_ok"] and got["alive"]
    if garbage:
        assert sum(got["malformed"].values()) >= 4


def test_udp_status_probe_like_jax():
    replies = {}
    for pk in (JAXP, TORCHP):
        loop = pk.core.WallClock()
        sched = pk.core.DeepRT(_table(pk), device=pk.core.SequentialDevice(loop), loop=loop)
        binding = pk.ing.UdpServerBinding(
            pk.ing.TransportServer(pk.ing.IngestGateway(sched))).start()
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        probe.settimeout(2.0)
        try:
            probe.sendto(pk.tr.encode_control(pk.tr.STATUS, {}), binding.addr)
            data, _ = probe.recvfrom(65535)
            mtype, body = pk.tr.decode(data)
            body.pop("now")
            replies[pk.name] = (mtype, json.dumps(body, sort_keys=True))
        finally:
            probe.close()
            binding.close()
    assert replies["torch"] == replies["jax"]
    assert replies["torch"][0] == PT.STATUS_REPLY and '"scheduler"' in replies["torch"][1]


# ---------------------------------------------------------------------------
# build_live_transport over live tiny clusters
# ---------------------------------------------------------------------------
MID = "granite-3-2b"
LIVE_CATS = [(MID, (16,), "prefill"), (MID, (8,), "decode")]
CHAOS = dict(p_drop=0.06, p_dup=0.06, p_reorder=0.08, p_delay=0.06, reorder_hold=(0.05, 0.2))


def _live(pk, build, **kw):
    """The live arm of ``benchmarks/transport_robustness.py`` at tiny
    size: two slices, three decode streams over seeded chaos links,
    session 1's home slice failed mid-stream."""
    cluster, slices, gateway, transport, binding = build(
        {MID: kw.pop("cfg")}, LIVE_CATS, slice_names=("slice0", "slice1"),
        batch_sizes=(1, 2, 4, 8), profile_runs=2, nonrt_cap=1, record_payloads=True, **kw)
    assert binding is None and cluster.rehome_owner is transport
    assert transport.gateway is gateway
    loop = cluster.loop
    # Deadlines with room for WCETs profiled on a loaded CPU: a survivor
    # must still admit the failed slice's tail.
    period, deadline, frames, fail_at = 0.5, 2.0, 8, 1.6
    sources, links = [], []
    for i in range(3):
        link = pk.ing.SimLink(loop, transport.datagram,
                              plan=pk.ing.LinkPlan.from_seed(2026 + i, frames * 4, **CHAOS))
        src = pk.ing.PeriodicSource(period=period, n_frames=frames, payload_shape=(), seed=80 + i)
        client = pk.ing.TransportSource(src, pk.core.Category(MID, (8,)), deadline, link)
        assert client.start(transport)
        sources.append(src)
        links.append(link)
    victim = transport.sessions[1]
    home = victim.session.slice_name
    loop.schedule(loop.now + fail_at, lambda: cluster.fail_slice(home), priority=0)
    try:
        cluster.run(until=loop.now + frames * period + 2.0)
        transport.finalize_all()
        cluster.run(until=loop.now + 1.0)
    finally:
        for sl in slices.values():
            sl.scheduler.device.close()
    return SimpleNamespace(cluster=cluster, slices=slices, transport=transport, victim=victim,
                           home=home, sources=sources, links=links, fail_at=fail_at,
                           period=period)


@pytest.fixture(scope="module")
def live():
    jrun = _live(JAXP, jbuild, cfg=jtiny(MID))
    jparams = next(iter(jrun.slices.values())).engine.params[MID]
    params = {MID: interop.params_from_numpy(tiny(MID), jax.tree.map(np.asarray, jparams),
                                             device="cpu")}
    trun = _live(TORCHP, tbuild, cfg=tiny(MID), device="cpu", params=params)
    return jrun, trun


def _live_structure(run):
    """What does not depend on the wall clock: which tail lands where and
    when does (each slice's own profiled WCETs decide), so the re-home
    itself is checked on the port's run alone."""
    agg = run.cluster.aggregate_metrics()
    return dict(
        sessions=len(run.transport.sessions),
        conserved=agg["completed_frames"] + agg["dropped_frames"] + agg["lost_frames"]
        == agg["ingested_frames"],
        wire=all(ts.wire_conserved() for ts in run.transport.sessions.values()),
        dead=[n for n, sl in run.slices.items() if not sl.alive] == [run.home])


def test_live_transport_structure_matches_jax(live):
    jrun, trun = live
    assert _live_structure(trun) == _live_structure(jrun)
    assert all(_live_structure(trun).values())


def test_live_transport_delivers_source_bytes_and_rehomes_real_ones(live):
    _, run = live
    assert run.victim.rehomes >= 1 and run.victim.session.slice_name != run.home
    for i, src in enumerate(run.sources):
        ts = run.transport.sessions[i + 1]
        assert ts.delivered_log == sorted(set(ts.delivered_log))
        for seq, payload in ts.delivered_payloads.items():
            assert np.array_equal(payload, src.payload(seq)), (i, seq)
    post = [s for s in run.victim.delivered_log if s * run.period >= run.fail_at]
    assert post, "no post-failover deliveries on the re-homed session"
    assert any(np.asarray(run.victim.delivered_payloads[s]).any() for s in post)
    survivors = [sl for sl in run.slices.values() if sl.alive]
    assert survivors and all(sl.engine.stats["decode_compiles"] == 0 for sl in survivors)
    dead = run.slices[run.home].engine
    with pytest.raises(RuntimeError, match="frozen"):
        dead.dispatch(MID, (8,), 1, "decode")


def test_build_live_transport_binds_udp_only_when_asked():
    import inspect

    sig = inspect.signature(tbuild)
    assert sig.parameters["device"].default == "cuda"
    assert sig.parameters["udp"].default is False
    assert sig.parameters["host"].default == "127.0.0.1"
    cluster, slices, gateway, transport, binding = tbuild(
        {MID: tiny(MID)}, LIVE_CATS, slice_names=("s0",), batch_sizes=(1, 2), profile_runs=1,
        nonrt_cap=1, device="cpu", udp=True, port=0)
    try:
        assert binding is not None and binding.addr[0] == "127.0.0.1" and binding.addr[1] > 0
        assert cluster.rehome_owner is transport and gateway.target is cluster
        assert cluster.telemetry_probes["transport"] == transport.telemetry
    finally:
        binding.close()
        for sl in slices.values():
            sl.scheduler.device.close()
