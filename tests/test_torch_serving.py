"""DeepRT serving through the port, and the copied scheduler against the
JAX package's.

- ``build_live_scheduler`` on the CPU with tiny granite-3-2b, one prefill
  and one decode category, serving a few requests on the WallClock.
- One ``generate_trace`` spec and seed through ``repro.core.DeepRT`` and
  ``repro_torch.core.DeepRT`` on the virtual EventLoop: identical metrics
  and an identical span sequence. Spans are compared by stage, frame
  index and time, with request ids mapped by first appearance (each
  package numbers requests with its own process-global counter).
"""
import pytest

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.configs.registry import tiny
from repro_torch.serving.batcher_bridge import build_live_scheduler

MID = "granite-3-2b"


def test_live_scheduler_serves_prefill_and_decode_on_cpu():
    cats = [(MID, (16,), "prefill"), (MID, (32,), "decode")]
    sched, engine, table = build_live_scheduler(
        {MID: tiny(MID)}, cats, batch_sizes=(1, 2, 4), device="cpu", profile_runs=2)
    assert engine.device.type == "cpu" and engine.max_slots == 8
    w_dec = table.wcet(MID, (32,), engine.max_slots)
    w_pre = table.wcet(MID, (16,), 4)
    deadline = max(12.0 * (w_dec + w_pre), 0.2)
    start = sched.loop.now + 0.02
    reqs = [
        tcore.Request(tcore.Category(MID, shape), period=deadline / 2,
                      relative_deadline=deadline, n_frames=4, start_time=start)
        for shape in ((32,), (32,), (16,))
    ]
    results = [sched.submit_request(r) for r in reqs]
    assert all(r.admitted for r in results)
    m = sched.run()
    assert m.completed_frames == 12
    assert m.completed_frames + m.dropped_frames + m.lost_frames == m.ingested_frames
    assert engine.stats["decode_compiles"] == 0
    assert engine.stats["dispatches"] == m.job_count > 0
    assert m.bucket_rows >= m.real_rows


def _run_sim(core, spec, table_entries):
    table = core.ProfileTable()
    for (mid, shape, b), w in table_entries.items():
        table.record(mid, shape, b, w)
    sched = core.DeepRT(table)
    tracer = core.FrameTracer()
    sched.attach_tracer(tracer, tag="solo")
    admitted = [sched.submit_request(r).admitted for r in core.generate_trace(spec)]
    m = sched.run()
    rid_order = {}
    spans = []
    for ev in tracer.ring:
        rid = rid_order.setdefault(ev.rid, len(rid_order)) if ev.rid >= 0 else -1
        spans.append((ev.stage, rid, ev.idx, round(ev.t, 12), ev.where, ev.cat))
    counts = dict(
        completed=m.completed_frames, missed=m.missed_frames, jobs=m.job_count,
        real_rows=m.real_rows, bucket_rows=m.bucket_rows, dropped=m.dropped_frames,
        delivered=m.delivered_frames, lost=m.lost_frames, overruns=m.overruns,
        batch_sizes=list(m.batch_sizes), latencies=[round(x, 12) for x in m.frame_latencies],
    )
    return admitted, counts, spans


@pytest.mark.parametrize("seed", [0, 3])
def test_copied_scheduler_matches_reference_on_virtual_time(seed):
    shapes = ((16,), (32,))
    entries = {
        (MID, shape, b): 0.002 * (1 + i) * (1 + 0.5 * b)
        for i, shape in enumerate(shapes) for b in (1, 2, 4, 8)
    }
    kw = dict(mean_period=0.05, mean_deadline=0.2, n_requests=12,
              frames_per_request=(10, 30), models=(MID,), max_categories=2,
              mean_interarrival=0.1, seed=seed)
    ja, jc, js = _run_sim(jcore, jcore.TraceSpec(shapes=shapes, **kw), entries)
    ta, tc, ts = _run_sim(tcore, tcore.TraceSpec(shapes=shapes, **kw), entries)
    assert ja == ta and any(ja)
    assert jc == tc and jc["completed"] > 0
    assert js == ts and len(js) > 0
