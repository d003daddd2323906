"""The port's DeepRT core against the JAX package's, on the CPU.

Twins of ``tests/test_core_scheduler.py``, ``tests/test_adaptation_cluster.py``
and ``tests/test_admission_properties.py``: the same seeded workloads go
through ``repro.core`` and ``repro_torch.core`` on the virtual
``EventLoop`` and must decide identically — ProfileTable lookups,
DisBatcher windows and emitted jobs, admission verdicts (phase,
utilisation, predicted completions), the EDF worker's job order with its
start and completion times, the adaptation module's shape changes and
restores, the cluster's placements and failovers, the baselines'
batches, metrics and the telemetry span sequence. Request ids are
renumbered by first appearance. Each case also keeps the reference
test's own assertion on the port's run. The hypothesis properties (P1,
P2) draw one workload's numbers and build it in both packages.
"""
import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro import core as J
from repro_torch import core as P

SHAPE = (3, 224, 224)
SETTINGS = settings(max_examples=15, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


class _Ids:
    def __init__(self):
        self.map = {}

    def __call__(self, rid):
        if rid is None or rid < 0:
            return rid
        return self.map.setdefault(rid, len(self.map))


def make_table(core, a=0.004, c=0.0015, model="m", shape=SHAPE, bmax=128):
    t = core.ProfileTable()
    b = 1
    while b <= bmax:
        t.record(model, shape, b, a + c * b)
        b *= 2
    return t


def shaped_table(core, a=0.004, c=0.0015):
    """The adaptation tests' table: three shapes, cheaper when smaller."""
    t = core.ProfileTable()
    for shape in [(3, 224, 224), (3, 112, 112), (3, 56, 56)]:
        scale = shape[1] / 224.0
        b = 1
        while b <= 128:
            t.record("m", shape, b, (a + c * b) * max(scale, 0.25))
            b *= 2
    return t


def _jobs(jobs, rid):
    return [(str(j.category), j.shape_key, j.release_time, j.relative_deadline,
             j.start_time, j.completion_time, j.profiled_wcet,
             [(rid(f.request_id), f.index, f.arrival_time, f.deadline) for f in j.frames])
            for j in jobs]


def _verdict(res, rid):
    return (res.admitted, res.phase, res.utilization, res.n_pseudo_jobs,
            sorted((rid(r), i, t) for (r, i), t in res.predicted_completions.items()))


def sched_summary(sched, verdicts=(), tracer=None):
    rid = _Ids()
    out = {"verdicts": [_verdict(v, rid) if hasattr(v, "phase") else v for v in verdicts]}
    m = sched.metrics
    out["metrics"] = (m.completed_frames, m.missed_frames, m.dropped_frames, m.lost_frames,
                      m.ingested_frames, m.job_count, m.overruns, list(m.batch_sizes),
                      list(m.frame_latencies),
                      sorted((rid(r), i, v) for (r, i), v in m.frame_records.items()))
    out["jobs"] = _jobs(sched.worker.completed_jobs, rid)
    ad = sched.adaptation
    out["adaptation"] = (ad.shape_changes, ad.restores,
                         sorted((str(c), v) for c, v in ad.sheds.items()))
    if tracer is not None:
        out["spans"] = [(ev.t, ev.stage, rid(ev.rid), ev.idx, ev.where, ev.cat)
                        for ev in tracer.ring]
    return out


def twin(scenario, *args):
    """Run ``scenario`` in both packages; the summaries must agree."""
    want, got = scenario(J, *args), scenario(P, *args)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    return got


# ---------------------------------------------------------------------------
# ProfileTable, DisBatcher
# ---------------------------------------------------------------------------
def table_queries(core):
    t = make_table(core)
    t8 = make_table(core, bmax=8)
    out = {"wcet": [t.wcet("m", SHAPE, b) for b in range(0, 200)],
           "beyond": [t8.wcet("m", SHAPE, b) for b in (8, 9, 16, 33, 100)],
           "scaled": t.scaled(2.0).wcet("m", SHAPE, 1),
           "json": core.ProfileTable.from_json(t.to_json()).wcet("m", SHAPE, 4)}
    with pytest.raises(KeyError):
        t.wcet("nope", (1,), 1)
    out["json_text"] = t.to_json()
    return out


def test_profile_table_matches_jax():
    got = twin(table_queries)
    w = got["wcet"]
    assert w[0] == 0.0 and all(b >= a - 1e-12 for a, b in zip(w, w[1:]))
    assert got["wcet"][5] == pytest.approx(0.004 + 0.0015 * 8)
    assert got["beyond"][2] == pytest.approx(got["beyond"][0] + 0.0015 * 8)
    assert got["scaled"] == pytest.approx(2 * got["wcet"][1])


def disbatcher_run(core, case):
    cat = core.Category("m", SHAPE)
    jobs, loop = [], core.EventLoop()
    db = core.DisBatcher(loop, emit=jobs.append)
    rid = _Ids()
    out = {}
    if case == "windows":
        r1 = core.Request(category=cat, period=0.1, relative_deadline=0.4, n_frames=3)
        r2 = core.Request(category=cat, period=0.1, relative_deadline=0.2, n_frames=3)
        db.add_request(r1)
        out["w1"] = db.window_of(cat)
        db.add_request(r2)
        out["w2"] = db.window_of(cat)
        nrt = core.Category("m", SHAPE, realtime=False)
        db.add_request(core.Request(category=nrt, period=0.05, relative_deadline=0.1,
                                    n_frames=2))
        out["nrt"] = db.window_of(nrt)
    elif case in ("same-window", "bounds"):
        period, dl, n = (0.01, 0.5, 5) if case == "same-window" else (0.04, 0.3, 20)
        r = core.Request(category=cat, period=period, relative_deadline=dl, n_frames=n)
        db.add_request(r)
        for i in range(n):
            at = i * period if case == "same-window" else r.frame_arrival(i)
            loop.schedule(at, lambda i=i: db.on_frame(
                core.Frame(r.request_id, cat, i, loop.now, loop.now + dl)))
        loop.run(until=0.3 if case == "same-window" else None)
    elif case == "early-flush":
        r = core.Request(category=cat, period=0.1, relative_deadline=1.0, n_frames=1)
        db.add_request(r)
        loop.schedule(0.01, lambda: db.on_frame(core.Frame(r.request_id, cat, 0, 0.01, 1.01)))
        loop.schedule(0.02, lambda: db.flush_early())
        loop.run(until=0.03)
    else:  # late request after the timer retired
        r1 = core.Request(category=cat, period=0.05, relative_deadline=0.2, n_frames=2)
        db.add_request(r1)
        loop.run(until=5.0)
        r2 = core.Request(category=cat, period=0.05, relative_deadline=0.2, n_frames=2,
                          start_time=5.0)
        db.add_request(r2)
        loop.schedule(5.0, lambda: db.on_frame(core.Frame(r2.request_id, cat, 0, 5.0, 5.2)))
        loop.run(until=6.0)
    out["jobs"] = _jobs(jobs, rid)
    out["deadlines"] = [(j.deadline, j.batch_size) for j in jobs]
    return out


@pytest.mark.parametrize("case", ["windows", "same-window", "bounds", "early-flush",
                                  "late-request"])
def test_disbatcher_matches_jax(case):
    got = twin(disbatcher_run, case)
    if case == "windows":
        assert got["w1"] == pytest.approx(P.WINDOW_FRACTION * 0.4)
        assert got["w2"] == pytest.approx(P.WINDOW_FRACTION * 0.2)
        assert got["nrt"] == pytest.approx(10.0)
    elif case == "same-window":
        assert got["deadlines"] == [(pytest.approx(0.5), 5)]
    elif case == "bounds":
        assert sum(b for _, b in got["deadlines"]) == 20
        for job in got["jobs"]:
            for frame in job[-1]:
                assert job[2] + job[3] <= frame[3] + 1e-9
    elif case == "early-flush":
        assert len(got["jobs"]) == 1 and got["jobs"][0][2] == pytest.approx(0.02)
    else:
        assert sum(b for _, b in got["deadlines"]) == 1


# ---------------------------------------------------------------------------
# DeepRT end to end, adaptation
# ---------------------------------------------------------------------------
def deeprt_run(core, case):
    cat = core.Category("m", SHAPE)
    table = make_table(core)
    exact = core.ExecutionModel(actual_fn=lambda j, w: w)
    tracer = core.FrameTracer()
    if case == "exact":
        sched = core.DeepRT(table, execution=exact)
        reqs = [core.Request(category=cat, period=0.05, relative_deadline=0.2, n_frames=40),
                core.Request(category=cat, period=0.03, relative_deadline=0.3, n_frames=60),
                core.Request(category=cat, period=0.08, relative_deadline=0.15, n_frames=30)]
    elif case == "rejected":
        sched = core.DeepRT(table)
        reqs = [core.Request(category=cat, period=0.001, relative_deadline=0.002,
                             n_frames=100)]
    elif case == "nonrt":
        sched = core.DeepRT(table)
        reqs = [core.Request(category=core.Category("m", SHAPE, realtime=False), period=0.01,
                             relative_deadline=0.1, n_frames=5)]
    else:  # EDF across categories
        for b in [1, 2, 4, 8]:
            table.record("m2", (3, 112, 112), b, 0.002 + 0.001 * b)
        sched = core.DeepRT(table, execution=exact)
        reqs = [core.Request(category=cat, period=0.1, relative_deadline=0.4, n_frames=10),
                core.Request(category=core.Category("m2", (3, 112, 112)), period=0.1,
                             relative_deadline=0.1, n_frames=10)]
    sched.attach_tracer(tracer, tag="solo")
    verdicts = [sched.submit_request(r) for r in reqs]
    sched.run()
    out = sched_summary(sched, verdicts, tracer)
    out["tracer"] = str(tracer.snapshot())
    return out


@pytest.mark.parametrize("case", ["exact", "rejected", "nonrt", "edf-categories"])
def test_deeprt_matches_jax(case):
    got = twin(deeprt_run, case)
    admitted = [v for v in got["verdicts"] if v[0]]
    completed, missed = got["metrics"][:2]
    if case == "exact":
        assert admitted and missed == 0
    elif case == "rejected":
        assert not admitted and completed == 0
    elif case == "nonrt":
        assert got["verdicts"][0][:2] == (True, 0) and completed == 5
    else:
        assert len(admitted) == 2 and missed == 0
        assert any(job[0].startswith("m2") for job in got["jobs"])


def _overrun_then_normal(n):
    count = {"n": 0}

    def actual_fn(job, wcet):
        count["n"] += 1
        return 3.0 * wcet if count["n"] <= n else 0.9 * wcet

    return actual_fn


def adaptation_run(core, case):
    cat = core.Category("m", SHAPE)
    table = shaped_table(core)
    if case == "injected":
        count = {"n": 0}

        def actual_fn(job, wcet):
            count["n"] += 1
            return 4.0 * wcet if count["n"] % 7 == 3 else 0.95 * wcet

        out = {}
        for enabled in (True, False):
            sched = core.DeepRT(shaped_table(core),
                                execution=core.ExecutionModel(actual_fn=actual_fn),
                                adaptation_enabled=enabled)
            verdicts = [sched.submit_request(core.Request(
                category=cat, period=0.05, relative_deadline=0.2, n_frames=60))
                for _ in range(3)]
            sched.run()
            out[enabled] = sched_summary(sched, verdicts)
            count["n"] = 0
        return out
    n, frames, enabled = {"reduce": (1, 20, True), "restore": (1, 30, True),
                          "disabled": (5, 20, False), "counted": (3, 20, True)}[case]
    sched = core.DeepRT(table, execution=core.ExecutionModel(actual_fn=_overrun_then_normal(n)),
                        adaptation_enabled=enabled)
    verdict = sched.submit_request(core.Request(category=cat, period=0.1,
                                                relative_deadline=0.4, n_frames=frames))
    sched.run()
    out = sched_summary(sched, [verdict])
    out["penalty"] = sched.adaptation.penalty(cat)
    return out


@pytest.mark.parametrize("case", ["reduce", "restore", "disabled", "counted", "injected"])
def test_adaptation_matches_jax(case):
    got = twin(adaptation_run, case)
    if case == "injected":
        assert got[True]["metrics"][1] <= got[False]["metrics"][1]
        return
    assert got["verdicts"][0][0]
    shapes = [job[1] for job in got["jobs"]]
    changes, restores, _ = got["adaptation"]
    if case == "reduce":
        assert changes >= 1 and (3, 112, 112) in shapes
    elif case == "restore":
        assert restores >= 1 and got["penalty"] == 0.0 and shapes[-1] == SHAPE
    elif case == "disabled":
        assert set(shapes) == {SHAPE}
    else:
        assert got["metrics"][6] >= 1


# ---------------------------------------------------------------------------
# ClusterScheduler and the baselines
# ---------------------------------------------------------------------------
def cluster_run(core, case):
    cat = core.Category("m", SHAPE)
    exact = core.ExecutionModel(actual_fn=lambda j, w: w)
    cluster = core.ClusterScheduler(execution=exact) if case == "zero-miss" else (
        core.ClusterScheduler())
    n = {"spread": 2, "failure": 2, "overload": 1, "slow": 1, "zero-miss": 2}[case]
    for i in range(n):
        cluster.add_slice(core.SliceSpec(name=f"slice{i}", table=shaped_table(core)))
    rid = _Ids()
    out = {}
    if case == "spread":
        reqs = [core.Request(category=cat, period=0.05, relative_deadline=0.3, n_frames=40)
                for _ in range(6)]
        out["placed"] = [bool(cluster.submit_request(r)) for r in reqs]
    elif case == "failure":
        for _ in range(4):
            cluster.submit_request(core.Request(category=cat, period=0.05,
                                                relative_deadline=0.3, n_frames=200))
        cluster.run(until=1.0)
        out["lost"] = len(cluster.fail_slice("slice0"))
        cluster.run()
    elif case == "overload":
        out["placed"] = [bool(cluster.submit_request(core.Request(
            category=cat, period=0.004, relative_deadline=0.05, n_frames=100)))
            for _ in range(30)]
    elif case == "slow":
        cluster.mark_slow("slice0", 4.0)
        out["placed"] = [bool(cluster.submit_request(core.Request(
            category=cat, period=0.006, relative_deadline=0.03, n_frames=50)))]
    else:
        for _ in range(4):
            cluster.submit_request(core.Request(category=cat, period=0.1,
                                                relative_deadline=0.4, n_frames=100))
        cluster.run(until=2.0)
        cluster.fail_slice("slice0")
        cluster.run()
    out["placement"] = sorted((rid(r), s) for r, s in cluster.placement.items())
    out["failover"] = sorted((rid(r), rid(t)) for r, t in cluster.failover_map.items())
    out["dropped"] = [rid(r.request_id) for r in cluster.dropped]
    out["reroutes"] = cluster.reroutes
    out["aggregate"] = cluster.aggregate_metrics()
    for name, sl in cluster.slices.items():
        out[name] = _jobs(sl.scheduler.worker.completed_jobs, rid)
    return out


@pytest.mark.parametrize("case", ["spread", "failure", "overload", "slow", "zero-miss"])
def test_cluster_scheduler_matches_jax(case):
    got = twin(cluster_run, case)
    if case == "spread":
        assert all(got["placed"]) and {s for _, s in got["placement"]} == {"slice0", "slice1"}
    elif case == "failure":
        assert got["aggregate"]["completed_frames"] > 0
    elif case == "overload":
        assert not all(got["placed"]) and got["dropped"]
    elif case == "slow":
        assert got["placed"] == [False]
    else:
        assert got["aggregate"]["miss_rate"] == 0.0


def baseline_run(core, case):
    cat = core.Category("m", SHAPE)
    if case == "batch":
        b = core.BATCH(shaped_table(core), loop=core.EventLoop(), batch_size=4)
        reqs = [(cat, 0.01, 0.5, 50)] * 4
    elif case == "aimd":
        b = core.AIMD(shaped_table(core))
        reqs = [(cat, 0.004, 1.0, 100)]
    elif case == "batch-delay":
        b = core.BATCHDelay(shaped_table(core), batch_size=64, max_delay=0.02)
        reqs = [(cat, 0.05, 0.5, 10)]
    else:
        b = core.BATCH(shaped_table(core), batch_size=1)
        reqs = [(cat, 0.02, 10.0, 50), (core.Category("m", (3, 112, 112)), 0.02, 10.0, 50)]
    for c, period, dl, n in reqs:
        b.submit_request(core.Request(category=c, period=period, relative_deadline=dl,
                                      n_frames=n))
    m = b.run()
    return {"metrics": (m.completed_frames, m.missed_frames, list(m.batch_sizes),
                        list(m.frame_latencies))}


@pytest.mark.parametrize("case", ["batch", "aimd", "batch-delay", "multitenant"])
def test_baselines_match_jax(case):
    completed, _, batches, lat = twin(baseline_run, case)["metrics"]
    if case == "batch":
        assert completed == 200 and max(batches) <= 4
    elif case == "aimd":
        assert completed == 100 and max(batches) > 1
    elif case == "batch-delay":
        assert completed == 10 and max(batches) < 64
    else:
        assert completed == 100 and lat


# ---------------------------------------------------------------------------
# Admission properties (P1-P3) and Algorithm 1
# ---------------------------------------------------------------------------
def build_workload(core, spec):
    """spec = (a, c, n_models, [(model index, period, deadline, n, start)])."""
    a, c, n_models, reqs = spec
    table = core.ProfileTable()
    cats = []
    for i in range(n_models):
        shape = (3, 64 * (i + 1), 64 * (i + 1))
        b = 1
        while b <= 256:
            table.record(f"m{i}", shape, b, a * (i + 1) + c * b)
            b *= 2
        cats.append(core.Category(model_id=f"m{i}", shape_key=shape))
    return table, [core.Request(category=cats[m], period=p, relative_deadline=d, n_frames=n,
                                start_time=s) for m, p, d, n, s in reqs]


@st.composite
def workloads(draw):
    n_models = draw(st.integers(1, 3))
    reqs = [(draw(st.integers(0, n_models - 1)), draw(st.floats(0.01, 0.3)),
             draw(st.floats(0.02, 0.5)), draw(st.integers(1, 40)), draw(st.floats(0.0, 1.0)))
            for _ in range(draw(st.integers(1, 8)))]
    return draw(st.floats(0.001, 0.01)), draw(st.floats(0.0005, 0.004)), n_models, reqs


def property_run(core, spec, early_flush):
    table, reqs = build_workload(core, spec)
    sched = core.DeepRT(table, execution=core.ExecutionModel(actual_fn=lambda j, w: w),
                        adaptation_enabled=False, early_flush=early_flush)
    verdicts = [sched.submit_request(r) for r in reqs]
    sched.run()
    out = sched_summary(sched, verdicts)
    rid = _Ids()
    predictions = {}
    for v in verdicts:
        if v.admitted:
            predictions.update(v.predicted_completions)
    records = sched.metrics.frame_records
    out["checks"] = dict(
        missed=sched.metrics.missed_frames,
        all_done=sched.metrics.completed_frames == sum(
            r.n_frames for r, v in zip(reqs, verdicts) if v.admitted),
        max_block=max((j.completion_time - j.start_time
                       for j in sched.worker.completed_jobs), default=0.0),
        pairs=sorted((rid(r), i, p, records[(r, i)][1], records[(r, i)][2])
                     for (r, i), p in predictions.items() if (r, i) in records))
    return out


@given(workloads(), st.booleans())
@SETTINGS
def test_p1_p2_admission_properties_match_jax(spec, early_flush):
    got = twin(property_run, spec, early_flush)["checks"]
    assert got["missed"] == 0 and got["all_done"]
    for _, _, predicted, deadline, actual in got["pairs"]:
        if early_flush:
            assert actual <= predicted + got["max_block"] + 1e-6
            assert actual <= max(predicted, deadline) + 1e-6
        else:
            assert actual <= predicted + 1e-6


def phase1_corpus(core):
    """P3a's corpus: Phase-1 utilisation and the Phase-2 verdict of every
    pending request of 200 seeded steady-state workloads."""
    out = []
    for seed in range(0, 200, 4):
        rng = random.Random(seed)
        table = core.ProfileTable()
        a, c = rng.uniform(0.002, 0.01), rng.uniform(0.001, 0.004)
        b = 1
        while b <= 256:
            table.record("m", SHAPE, b, a + c * b)
            b *= 2
        cat = core.Category("m", SHAPE)
        reqs = [core.Request(category=cat, period=rng.uniform(0.02, 0.2),
                             relative_deadline=rng.uniform(0.05, 0.4), n_frames=50,
                             start_time=0.0) for _ in range(rng.randint(2, 6))]
        sched = core.DeepRT(table, adaptation_enabled=False)
        admission = core.AdmissionControl(table)
        for r in reqs:
            state = core.snapshot_from_scheduler(
                now=0.0, disbatcher=sched.disbatcher, queued_jobs=[], device_free_at=0.0,
                table=table, pending=r)
            u = admission.phase1_utilization(state.categories)
            jobs = admission.generate_pseudo_jobs(state)
            ok, preds = admission.edf_imitator(jobs, 0.0)
            out.append((u, ok, len(jobs), sorted(preds.values()) if isinstance(preds, dict)
                        else preds))
            sched.submit_request(r)
    overload = core.DeepRT(core.ProfileTable())
    for b in [1, 2, 4, 8]:
        overload.table.record("m", SHAPE, b, 0.05 + 0.04 * b)
    phases = [overload.submit_request(core.Request(
        category=core.Category("m", SHAPE), period=0.01, relative_deadline=0.3,
        n_frames=50)) for _ in range(10)]
    return {"corpus": out, "overload": [(v.admitted, v.phase) for v in phases]}


def test_phase1_corpus_and_overload_match_jax():
    got = twin(phase1_corpus)
    checked = [(u, ok) for u, ok, _, _ in got["corpus"] if ok]
    assert len(checked) > 20 and all(u <= 1.0 + 1e-9 for u, _ in checked)
    assert any(not adm and phase == 1 for adm, phase in got["overload"])


IMITATOR = {
    "schedulable": ([(0.0, 0.1, 0.3), (0.0, 0.1, 0.5)], 0.0, True),
    "overload": ([(0.0, 0.3, 0.2)], 0.0, False),
    "idle-gap": ([(0.0, 0.1, 0.2), (5.0, 0.1, 0.2)], 0.0, True),
    "blocking": ([(0.0, 1.0, 10.0), (0.1, 0.1, 0.2)], 0.0, False),
    "busy-device": ([(0.0, 0.1, 0.15)], 0.1, False),
    "edf-order": ([(0.0, 0.1, 1.0), (0.0, 0.1, 0.15)], 0.0, True),
}


@pytest.mark.parametrize("name", list(IMITATOR))
def test_edf_imitator_matches_jax(name):
    jobs, start, want_ok = IMITATOR[name]

    def run(core):
        cat = core.Category("m", (1,))
        pj = [core.PseudoJob(cat, rel, ex, dl, 1) for rel, ex, dl in jobs]
        ok, preds = core.AdmissionControl.edf_imitator(pj, start)
        return {"ok": ok, "preds": repr(preds)}

    got = twin(run)
    assert got["ok"] is want_ok


def test_random_imitator_verdicts_match_jax():
    rng = random.Random(3)
    for _ in range(200):
        jobs = [(rng.uniform(0, 1), rng.uniform(0.01, 0.3), rng.uniform(0.05, 1.0),
                 rng.randint(1, 4)) for _ in range(rng.randint(1, 8))]
        start = rng.uniform(0, 0.5)
        res = {}
        for core in (J, P):
            cat = core.Category("m", (1,))
            pj = [core.PseudoJob(cat, r, e, d, n) for r, e, d, n in jobs]
            res[core is P] = repr(core.AdmissionControl.edf_imitator(pj, start))
        assert res[True] == res[False]
