"""The port's cluster layer against the JAX package's, on the CPU.

Simulation twins (virtual time, no model): the same seeded scenarios go
through ``repro.core`` and ``repro_torch.core`` — ``build_sim_cluster``
with fault plans and the health watchdog, parked tails, operator
failures, a chaos seed sweep plus a hypothesis property over seeds, and
the paper's baseline schedulers on one trace. Placement attempts,
failover maps, parked-tail outcomes, health transitions, metrics,
telemetry snapshots and span sequences ``(t, stage, rid, idx, where,
cat)`` must be identical. Request ids are mapped by first appearance:
each package numbers requests with its own process-global counter.

Live twins (tiny granite-3-2b, float32): ``build_live_cluster`` of both
packages, the port's engines on the JAX engines' parameters carried
through ``interop`` and ``params=``. A slice killed mid-decode: the
same placement and failover accounting, conservation, zero survivor
decode builds, a frozen dead engine. A wedged slice under the armed
watchdog: quarantined with no operator call, the same transitions.
"""
import json

import jax
import numpy as np
import pytest

from repro import core as J
from repro.configs.registry import tiny as jtiny
from repro.serving.batcher_bridge import build_live_cluster as jbuild
from repro_torch import core as P
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.models.layers import tree_leaves
from repro_torch.serving.batcher_bridge import build_live_cluster as tbuild

SIM_MID = "m"
SIM_SHAPE = (3, 224, 224)
WD = dict(slack=2.0, hang_slack=8.0, min_deadline=0.0)


def _table(core):
    t = core.ProfileTable()
    b = 1
    while b <= 16:
        t.record(SIM_MID, SIM_SHAPE, b, 0.004 + 0.0015 * b)
        b *= 2
    return t


def _req(core, period=0.05, deadline=0.5, n_frames=20):
    return core.Request(category=core.Category(SIM_MID, SIM_SHAPE), period=period,
                        relative_deadline=deadline, n_frames=n_frames)


class _Ids:
    """Request ids renumbered by first appearance."""

    def __init__(self):
        self.map = {}

    def __call__(self, rid):
        if rid is None or rid < 0:
            return rid
        return self.map.setdefault(rid, len(self.map))


def summarize(cluster, tracer=None):
    """Everything a cluster decided, with ids renumbered."""
    rid = _Ids()
    out = {
        "attempts": [(rid(r), ranked, chosen) for r, ranked, chosen in cluster.placement_attempts],
        "placement": sorted((rid(r), n) for r, n in cluster.placement.items()),
        "failover_map": sorted((rid(r), rid(t)) for r, t in cluster.failover_map.items()),
        "finished_with_slice": [rid(r) for r in cluster.finished_with_slice],
        "parked_admitted": [rid(r) for r in cluster.parked_admitted],
        "parked_expired": [rid(r) for r in cluster.parked_expired],
        "parked": sorted(rid(r) for r in cluster.parked),
        "dropped": [rid(r.request_id) for r in cluster.dropped],
        "reroutes": cluster.reroutes,
        "transitions": list(cluster.health.transitions),
        "reprofiles": dict(cluster.health.reprofiles),
        "submit_errors": dict(cluster.health.submit_errors),
        "aggregate": cluster.aggregate_metrics(),
    }
    for name, sl in cluster.slices.items():
        m = sl.scheduler.metrics
        out[f"slice {name}"] = dict(
            health=sl.health, alive=sl.alive, slow_factor=sl.slow_factor,
            completed=m.completed_frames, missed=m.missed_frames, lost=m.lost_frames,
            delivered=m.delivered_frames, jobs=m.job_count, batches=list(m.batch_sizes),
            latencies=list(m.frame_latencies), leases=sorted(rid(r) for r in sl.leases),
            wcet=sl.scheduler.table.wcet(SIM_MID, SIM_SHAPE, 1),
        )
    snap = cluster.telemetry_snapshot()
    snap.pop("tracer", None)
    snap.pop("attribution", None)
    out["snapshot"] = json.dumps(snap, sort_keys=True, default=str)
    if tracer is not None:
        out["spans"] = [(ev.t, ev.stage, rid(ev.rid), ev.idx, ev.where, ev.cat)
                        for ev in tracer.ring]
    return out


# ---------------------------------------------------------------------------
# Scenarios: each takes a core package and returns (cluster, tracer)
# ---------------------------------------------------------------------------
def _watched(core, plans, n_slices=1, **wd):
    cfg = core.WatchdogConfig(**{**WD, **wd})
    names = tuple(f"s{i}" for i in range(n_slices))
    cluster = core.build_sim_cluster(lambda: _table(core), names, fault_plans=plans,
                                     watchdog=cfg)
    tracer = core.FrameTracer()
    cluster.attach_tracer(tracer)
    return cluster, tracer


def scenario_stall_hang(core):
    plans = {"s0": core.FaultPlan((core.FaultSpec(core.STALL, 3),))}
    cluster, tracer = _watched(core, plans, suspect_after=2, quarantine_after=50)
    assert cluster.submit_request(_req(core, n_frames=30))
    cluster.run()
    assert cluster.slices["s0"].health == core.QUARANTINED
    return cluster, tracer


def scenario_drift_quarantine(core):
    plans = {"s0": core.FaultPlan(tuple(core.FaultSpec(core.DELAY, i, factor=3.0)
                                        for i in range(2, 12)))}
    cluster, tracer = _watched(core, plans, suspect_after=2, quarantine_after=4)
    assert cluster.submit_request(_req(core, n_frames=40))
    cluster.run()
    return cluster, tracer


def scenario_recovery(core):
    plans = {"s0": core.FaultPlan(tuple(core.FaultSpec(core.DELAY, i, factor=3.0)
                                        for i in range(2, 8)))}
    cluster, tracer = _watched(core, plans, suspect_after=2, quarantine_after=50,
                               recover_after=3)
    assert cluster.submit_request(_req(core, n_frames=40))
    cluster.run()
    assert cluster.slices["s0"].health == core.HEALTHY
    return cluster, tracer


def scenario_reprofile(core):
    plans = {"s0": core.FaultPlan(tuple(core.FaultSpec(core.DELAY, i, factor=3.0)
                                        for i in range(2, 6)))}
    cluster, tracer = _watched(core, plans, suspect_after=2, quarantine_after=50,
                               reprofile_samples=4)
    assert cluster.submit_request(_req(core, n_frames=30))
    cluster.run()
    return cluster, tracer


def scenario_transient_error(core):
    plans = {"s0": core.FaultPlan((core.FaultSpec(core.SUBMIT_ERROR, 2),))}
    cluster, tracer = _watched(core, plans)
    assert cluster.submit_request(_req(core, n_frames=10))
    cluster.run()
    return cluster, tracer


def _two_slices(core, bound_s1):
    cluster = core.ClusterScheduler()
    cluster.add_slice(core.SliceSpec(name="s0", table=_table(core)))
    cluster.add_slice(core.SliceSpec(name="s1", table=_table(core),
                                     utilization_bound=bound_s1))
    tracer = core.FrameTracer()
    cluster.attach_tracer(tracer)
    return cluster, tracer


def scenario_parked_expires(core):
    cluster, tracer = _two_slices(core, 0.0001)
    assert cluster.submit_request(_req(core, n_frames=40))
    cluster.loop.schedule(0.3, lambda: cluster.fail_slice("s0"))
    cluster.run()
    assert len(cluster.parked_expired) == 1
    return cluster, tracer


def scenario_parked_admitted(core):
    cluster, tracer = _two_slices(core, 0.06)
    assert cluster.submit_request(_req(core, n_frames=60))
    assert cluster.submit_request(_req(core, n_frames=12))
    cluster.loop.schedule(0.3, lambda: cluster.fail_slice("s0"))
    cluster.run()
    assert len(cluster.parked_admitted) == 1
    return cluster, tracer


def scenario_operator_failover(core):
    cluster, tracer = _watched(core, {}, n_slices=3)
    for n in (50, 30, 40, 20):
        assert cluster.submit_request(_req(core, period=0.04, n_frames=n))
    cluster.run(until=0.2)
    cluster.fail_slice("s1")
    cluster.health._set_state("s2", core.SUSPECT, "test")
    assert cluster.submit_request(_req(core, n_frames=5))
    cluster.health._set_state("s2", core.HEALTHY, "test")
    cluster.mark_slow("s2", 1.5)
    cluster.run()
    return cluster, tracer


SCENARIOS = {
    "stall-hang": scenario_stall_hang,
    "drift-quarantine": scenario_drift_quarantine,
    "recovery": scenario_recovery,
    "reprofile": scenario_reprofile,
    "transient-error": scenario_transient_error,
    "parked-expires": scenario_parked_expires,
    "parked-admitted": scenario_parked_admitted,
    "operator-failover": scenario_operator_failover,
}


def _conserved(cluster):
    agg = cluster.aggregate_metrics()
    return (agg["completed_frames"] + agg["dropped_frames"] + agg["lost_frames"]
            == agg["ingested_frames"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sim_scenario_matches_jax(name):
    want = summarize(*SCENARIOS[name](J))
    got_cluster, tracer = SCENARIOS[name](P)
    got = summarize(got_cluster, tracer)
    assert got == want
    assert _conserved(got_cluster)
    assert got["spans"]


def run_chaos(core, seed, n_slices=2):
    cfg = core.WatchdogConfig(suspect_after=2, quarantine_after=4, **WD)
    names = tuple(f"s{i}" for i in range(n_slices))
    plans = {
        name: core.FaultPlan.from_seed(seed * 101 + i, n_submits=60, p_delay=0.1,
                                       p_stall=0.02, p_error=0.05, p_death=0.01)
        for i, name in enumerate(names)
    }
    cluster = core.build_sim_cluster(lambda: _table(core), names, fault_plans=plans,
                                     watchdog=cfg)
    tracer = core.FrameTracer()
    cluster.attach_tracer(tracer)
    for _ in range(n_slices + 1):
        cluster.submit_request(_req(core, period=0.04, n_frames=20 + (seed % 3) * 10))
    cluster.run()
    return cluster, tracer


def assert_chaos_invariants(cluster):
    assert _conserved(cluster), cluster.aggregate_metrics()
    assert cluster.parked == {}
    assert len(cluster.parked_admitted) + len(cluster.parked_expired) == len(
        set(cluster.parked_admitted) | set(cluster.parked_expired))
    for name, sl in cluster.slices.items():
        if sl.alive:
            continue
        for rid, placed_on in cluster.placement.items():
            assert placed_on != name or rid in cluster.failover_map


def _chaos_twin(seed, n_slices):
    want = summarize(*run_chaos(J, seed, n_slices))
    cluster, tracer = run_chaos(P, seed, n_slices)
    assert summarize(cluster, tracer) == want
    assert_chaos_invariants(cluster)


@pytest.mark.parametrize("seed", range(8))
def test_chaos_seed_matches_jax_and_conserves(seed):
    _chaos_twin(seed, 2)


def test_chaos_conservation_property():
    """Any seed-derived fault plan on 1-3 slices: the port decides as the
    reference does, and conservation holds."""
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=12, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(0, 2**31 - 1), n_slices=st.integers(1, 3))
    def prop(seed, n_slices):
        _chaos_twin(seed, n_slices)

    prop()


def test_fail_slice_errors_match_jax():
    for core in (J, P):
        cluster = core.build_sim_cluster(lambda: _table(core), ("s0", "s1"))
        with pytest.raises(KeyError, match="unknown slice 'nope'"):
            cluster.fail_slice("nope")
        cluster.fail_slice("s0")
        with pytest.raises(RuntimeError, match="already failed"):
            cluster.fail_slice("s0")
        with pytest.raises(RuntimeError, match="no measured completions"):
            cluster.mark_slow("s1")


# ---------------------------------------------------------------------------
# Baselines: identical metrics on one trace
# ---------------------------------------------------------------------------
BASELINES = {
    "AIMD": lambda core, t: core.AIMD(t),
    "BATCH": lambda core, t: core.BATCH(t, batch_size=4),
    "BATCHDelay": lambda core, t: core.BATCHDelay(t, batch_size=8, max_delay=0.03),
    "SEDF": lambda core, t: core.SEDF(t),
}


def _baseline_run(core, name):
    table = core.ProfileTable()
    shapes = ((16,), (32,))
    for i, shape in enumerate(shapes):
        for b in (1, 2, 4, 8, 16, 32, 64):
            table.record(SIM_MID, shape, b, 0.002 * (1 + i) * (1 + 0.5 * b))
    spec = core.TraceSpec(mean_period=0.05, mean_deadline=0.3, n_requests=10,
                          frames_per_request=(10, 30), models=(SIM_MID,), shapes=shapes,
                          max_categories=2, mean_interarrival=0.1, seed=5)
    sched = BASELINES[name](core, table)
    verdicts = [sched.submit_request(r) for r in core.generate_trace(spec)]
    m = sched.run()
    return dict(verdicts=verdicts, completed=m.completed_frames, missed=m.missed_frames,
                batches=list(m.batch_sizes), latencies=list(m.frame_latencies),
                overdue=list(m.overdue_times), throughput=m.throughput)


@pytest.mark.parametrize("name", list(BASELINES))
def test_baselines_match_jax(name):
    want = _baseline_run(J, name)
    got = _baseline_run(P, name)
    assert got == want
    assert got["completed"] > 0


def test_core_exports_match_jax():
    assert set(J.__all__) <= set(P.__all__)
    assert set(P.__all__) - set(J.__all__) == {"arena_slots"}


# ---------------------------------------------------------------------------
# Live twins: tiny granite-3-2b clusters of both packages on the CPU
# ---------------------------------------------------------------------------
MID = "granite-3-2b"
SEQ_PRE = 16
SEQ_DEC = 8
CATS = [(MID, (SEQ_PRE,), "prefill"), (MID, (SEQ_DEC,), "decode")]


def _converted(jslices):
    """The JAX slices' parameters (one draw, shared by every slice) as
    port tensors."""
    jparams = next(iter(jslices.values())).engine.params[MID]
    return {MID: interop.params_from_numpy(tiny(MID), jax.tree.map(np.asarray, jparams),
                                           device="cpu")}


def _frame_done(slices, rid, index):
    return any((rid, index) in sl.scheduler.metrics.frame_records for sl in slices.values())


def _failover(core, build, **kw):
    cluster, slices = build({MID: kw.pop("cfg")}, CATS, slice_names=("s0", "s1"),
                            batch_sizes=(1, 2, 4), profile_runs=2, nonrt_cap=1, **kw)
    # The JAX engine compiles its arena-row reset at the first lease
    # (half a second idle, longer on a loaded host): lease and free a
    # row on each slice first, so that no stream starts before another.
    for sl in slices.values():
        sl.engine.free_slots(MID, SEQ_DEC, sl.engine.alloc_slots(MID, SEQ_DEC, 1))
    cat = core.Category(MID, (SEQ_DEC,))
    start = cluster.loop.now + 0.1
    reqs = [core.Request(category=cat, period=0.2, relative_deadline=0.4, n_frames=12,
                         start_time=start)
            for _ in range(4)]
    admitted = [cluster.submit_request(r) for r in reqs]
    # The slice fails once every placed stream has completed frame 1: an
    # event of the streams, not an instant of the host's clock (bounded
    # by the streams' last arrival, should a frame never complete).
    while (cluster.loop.now < reqs[0].end_time
           and not all(_frame_done(slices, rid, 1) for rid in cluster.placement)):
        cluster.run(until=cluster.loop.now + 0.01)
    by_slice = {}
    for rid, name in cluster.placement.items():
        by_slice.setdefault(name, []).append(rid)
    dead = max(by_slice, key=lambda n: (len(by_slice[n]), n))
    survivor = next(n for n in slices if n != dead)
    surv_live = len(slices[survivor].engine.arena(MID, SEQ_DEC).live)
    parked_now = cluster.fail_slice(dead)
    grew = len(slices[survivor].engine.arena(MID, SEQ_DEC).live) - surv_live
    dead_stats = dict(slices[dead].engine.stats)
    cluster.run()
    # Which slice a stream lands on follows each slice's own profiled
    # WCETs (timings), and how many frames a tail keeps follows the
    # loop's pace: the twins compare the accounting's structure, per
    # victim.
    # Whether a parked tail is admitted before it expires follows the
    # survivor's WCETs too: both count as displaced, each in one ledger.
    victims = by_slice[dead]
    outcomes = []
    for r in victims:
        assert (r in cluster.finished_with_slice) != (r in cluster.failover_map)
        if r in cluster.finished_with_slice:
            outcomes.append("finished")
            continue
        outcomes.append("displaced")
        if cluster.failover_map[r] is None:
            assert r in cluster.parked_expired
        else:
            tail = cluster.requests[cluster.failover_map[r]]
            assert cluster.placement[tail.request_id] == survivor
            assert tail.n_frames < 12
    # A tail the survivor's admission refuses at the failover instant is
    # parked and retried (the survivor's WCETs decide which): either way
    # it is re-admitted once, on the survivor's arena.
    assert grew + len(cluster.parked_admitted) == cluster.reroutes
    assert len(parked_now) == len(cluster.parked_admitted) + len(cluster.parked_expired)
    out = dict(
        admitted=admitted, victims=len(victims), outcomes=sorted(outcomes),
        finished_elsewhere=len(cluster.finished_with_slice) - outcomes.count("finished"),
        parked=len(cluster.parked), transitions=[
            (name == dead, old, new) for _t, name, old, new, _r in cluster.health.transitions],
    )
    return out, cluster, slices, dead, survivor, dead_stats


@pytest.fixture(scope="module")
def failover():
    jout, jcluster, jslices, *_ = _failover(J, jbuild, cfg=jtiny(MID))
    tout, cluster, slices, dead, survivor, dead_stats = _failover(
        P, tbuild, cfg=tiny(MID), device="cpu", params=_converted(jslices))
    return jout, tout, cluster, slices, dead, survivor, dead_stats


def test_live_failover_accounting_matches_jax(failover):
    jout, tout, cluster, _slices, dead, *_ = failover
    assert tout == jout
    assert tout["victims"] >= 2 and tout["outcomes"].count("displaced") >= 1
    assert cluster.reroutes == sum(t is not None for t in cluster.failover_map.values())
    assert tout["finished_elsewhere"] == 0 and tout["parked"] == 0
    assert all(name != dead for name in cluster.placement.values())


def test_live_failover_conserves_and_freezes_the_dead_slice(failover):
    _, _, cluster, slices, dead, survivor, dead_stats = failover
    agg = cluster.aggregate_metrics()
    assert (agg["completed_frames"] + agg["dropped_frames"] + agg["lost_frames"]
            == agg["ingested_frames"])
    assert agg["lost_frames"] > 0 and cluster.parked == {}
    eng = slices[dead].engine
    assert eng.frozen and dict(eng.stats) == dead_stats
    for op in (lambda: eng.dispatch(MID, (SEQ_DEC,), 1, "decode"),
               lambda: eng.alloc_slots(MID, SEQ_DEC, 1),
               lambda: eng.decode_chunk(MID, (SEQ_DEC,), 1, 1)):
        with pytest.raises(RuntimeError, match="frozen"):
            op()
    surv = slices[survivor]
    assert surv.engine.stats["decode_compiles"] == 0
    assert surv.engine.stats["dispatches"] > 0
    assert surv.leases == {}
    assert len(surv.engine.arena(MID, SEQ_DEC).free) == surv.engine.max_slots


def test_live_cluster_slices_share_seeded_weights_and_keep_own_arenas():
    cluster, slices = tbuild({MID: tiny(MID)}, CATS, slice_names=("s0", "s1"),
                             batch_sizes=(1, 2), profile_runs=1, nonrt_cap=1, device="cpu")
    e0, e1 = slices["s0"].engine, slices["s1"].engine
    for a, b in zip(tree_leaves(e0.params[MID]), tree_leaves(e1.params[MID])):
        assert a.data_ptr() != b.data_ptr() and bool((a == b).all())
    a0, a1 = e0.arena(MID, SEQ_DEC), e1.arena(MID, SEQ_DEC)
    assert a0 is not a1
    assert a0.cache["super"][0]["k"].data_ptr() != a1.cache["super"][0]["k"].data_ptr()
    assert set(cluster.telemetry_probes) == {"engine_s0", "engine_s1"}
    with pytest.raises(ValueError, match="unknown slices"):
        tbuild({MID: tiny(MID)}, CATS, slice_names=("s0",), utilization_bounds={"x": 0.5},
               device="cpu")
    for sl in slices.values():
        sl.device.close()


def _watchdog_run(core, build, **kw):
    from importlib import import_module

    ingest = import_module(core.__name__.split(".")[0] + ".ingest")
    wd = core.WatchdogConfig(slack=3.0, hang_slack=9.0, min_deadline=0.05,
                             suspect_after=2, quarantine_after=4)
    plans = {"s0": core.FaultPlan((core.FaultSpec(core.STALL, 2),))}
    cluster, slices = build({MID: kw.pop("cfg")}, CATS, slice_names=("s0", "s1"),
                            batch_sizes=(1, 2), profile_runs=2, nonrt_cap=1, watchdog=wd,
                            fault_plans=plans, **kw)
    gw = ingest.IngestGateway(cluster)
    sessions = [gw.register(ingest.CameraSource(period=0.2, n_frames=8, payload_shape=(),
                                                seed=40 + i),
                            core.Category(MID, (SEQ_DEC,)), relative_deadline=0.4)
                for i in range(3)]
    cluster.run()
    return cluster, slices, sessions


def _watchdog_seen(cluster, slices, sessions=()):
    """What a watchdog run did, for the assertions' messages: s0's
    transitions and reasons, each session's slice and state, the parked
    tails and the survivor's decode builds and leases."""
    surv = slices["s1"]
    return {
        "s0": [(o, w, r) for _t, n, o, w, r in cluster.health.transitions if n == "s0"],
        "s1": [(o, w, r) for _t, n, o, w, r in cluster.health.transitions if n == "s1"],
        "sessions": [(s.slice_name, s.state) for s in sessions],
        "parked": sorted(cluster.parked),
        "survivor": {"decode_compiles": surv.engine.stats["decode_compiles"],
                     "leases": dict(surv.leases), "health": surv.health},
    }


def test_live_watchdog_quarantines_the_wedged_slice_like_jax():
    jcluster, jslices, jsessions = _watchdog_run(J, jbuild, cfg=jtiny(MID))
    cluster, slices, sessions = _watchdog_run(P, tbuild, cfg=tiny(MID), device="cpu",
                                              params=_converted(jslices))
    seen = _watchdog_seen(cluster, slices, sessions)
    jseen = _watchdog_seen(jcluster, jslices, jsessions)
    assert slices["s0"].health == P.QUARANTINED and not slices["s0"].alive, seen
    reasons = [r for _, n, _, new, r in cluster.health.transitions
               if n == "s0" and new == P.QUARANTINED]
    assert reasons and "hung" in reasons[0], seen
    inner = slices["s0"].device.inner
    assert inner.wedged and inner.closed, seen
    # The wedged slice ends as the reference's does; which slice each
    # stream lands on follows the slices' own profiled WCETs, so the
    # sessions are held to the reference's rule.
    for cl, what in ((cluster, seen), (jcluster, jseen)):
        last = [(w, r) for _t, n, _o, w, r in cl.health.transitions if n == "s0"][-1]
        assert last[0] == P.QUARANTINED and "hung" in last[1], what
    assert any(s.slice_name == "s0" for s in sessions), seen
    assert all(s.state == ("failover" if s.slice_name == "s0" else "active")
               for s in sessions), seen
    assert all(s.conserved() for s in sessions), seen
    assert _conserved(cluster) and cluster.parked == {}, seen
    surv = slices["s1"]
    assert surv.engine.stats["decode_compiles"] == 0 and surv.leases == {}, seen
