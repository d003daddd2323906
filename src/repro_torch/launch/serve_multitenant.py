"""End-to-end driver: multi-tenant LIVE serving on the port (the twin of
``examples/serve_multitenant.py``).

Two language models share one device. The engine runs batched prefill
steps, the offline profiler (paper §4.1) measures WCETs, and DeepRT
schedules real executions on a wall clock, admission control included.
Dispatch is asynchronous (zero-stall): the scheduler loop keeps batching
and admitting while the device executes, and the footer reports how
little host time each job's dispatch cost. A BATCH baseline (batch 4)
runs the same accepted trace, simulated on the measured table.

With ``--slices N`` (N > 1) the workload runs on a LIVE CLUSTER
(``build_live_cluster``): N slices on one wall clock, each with its own
engine, resident arenas, AsyncDevice and WCET table; placement routes
each request to the lowest-utilization capable slice and that slice's
admission decides (spill-on-reject).

With ``--source camera|burst|trace`` every frame carries real payload
tokens through the ingest gateway (``repro_torch.ingest``): a jittery
camera, a bursty WebRTC-like source or a trace replay, deadline-stamped
at arrival, staged through the engine's double-buffered rings, with
adaptation-driven load shedding counted in the metrics.

With ``--transport`` the cluster sits behind the network front door
(``repro_torch.ingest.transport``): each stream is a datagram client
behind a seed-derived chaotic link (drops, duplicates, reordering,
delay), reassembled in order at the server, with credit-based
backpressure and session re-homing for slice failover.

``--trace PATH`` writes the frame lifecycle as a Chrome trace
(``FrameTracer``). ``--device`` places every engine (the card by
default; ``cpu`` for a run without one). The CLI serves tiny
granite-3-2b and rwkv6-1.6b; ``serve`` takes any configs.

  PYTHONPATH=src python -m repro_torch.launch.serve_multitenant [--requests 8]
  PYTHONPATH=src python -m repro_torch.launch.serve_multitenant --slices 2
  PYTHONPATH=src python -m repro_torch.launch.serve_multitenant --slices 2 --source camera
  PYTHONPATH=src python -m repro_torch.launch.serve_multitenant --slices 2 --transport
"""
from __future__ import annotations

import argparse
import copy
import json
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import tiny
from repro_torch.core import BATCH, Category, EventLoop, FrameTracer, TraceSpec, generate_trace
from repro_torch.ingest import (
    BurstSource,
    CameraSource,
    IngestGateway,
    LinkPlan,
    SimLink,
    TraceSource,
    TransportSource,
)
from repro_torch.serving.batcher_bridge import (
    build_live_cluster,
    build_live_scheduler,
    build_live_transport,
)

ARCHS = ("granite-3-2b", "rwkv6-1.6b")
PERIOD, DEADLINE = 0.3, 0.6


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--frames", type=int, default=15)
    ap.add_argument("--slices", type=int, default=1,
                    help="N > 1 serves through a live multi-slice cluster")
    ap.add_argument("--source", choices=("camera", "burst", "trace"), default=None,
                    help="stream real payload bytes through the ingest gateway")
    ap.add_argument("--transport", action="store_true",
                    help="serve through the network front door: chaotic link, "
                         "reassembly, client backpressure (implies a cluster)")
    ap.add_argument("--chaos-seed", type=int, default=7,
                    help="seed for the per-stream LinkPlan (--transport)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="dump the frame-lifecycle trace as Chrome trace_event "
                         "JSON (load via chrome://tracing or https://ui.perfetto.dev)")
    ap.add_argument("--device", default="cuda",
                    help="where every engine lives (cuda, or cpu)")
    return ap.parse_args(argv)


class _Run:
    """One run of the driver over ``configs``: the flags' topology, its
    sources and its printed scorecards."""

    def __init__(self, configs: Dict[str, ModelConfig], requests: int, seq: int,
                 frames: int, source: Optional[str], chaos_seed: int,
                 trace: Optional[str], device: str):
        self.configs = configs
        self.arch_ids = tuple(configs)
        self.categories = [(a, (seq,), "prefill") for a in self.arch_ids]
        self.requests, self.seq, self.frames = requests, seq, frames
        self.source, self.chaos_seed, self.trace, self.device = (
            source, chaos_seed, trace, device)
        # One tracer spans whatever topology the flags select: wire
        # receive, gateway shed verdicts, window closes, EDF dispatch,
        # completions.
        self.tracer = FrameTracer() if trace else None
        self.record: dict = {"slices": {}}

    def trace_spec(self) -> TraceSpec:
        return TraceSpec(
            mean_period=PERIOD, mean_deadline=DEADLINE, n_requests=self.requests,
            frames_per_request=(self.frames, self.frames), models=self.arch_ids,
            shapes=((self.seq,),), seed=3,
        )

    def sources(self):
        """One payload-carrying source per request slot (``--source``)."""
        if self.source == "trace":
            return [(req.category, req.relative_deadline, src)
                    for req, src in TraceSource.from_trace(self.trace_spec(),
                                                           payload_shape=(self.seq,))]
        out = []
        for i in range(self.requests):
            cat = Category(self.arch_ids[i % len(self.arch_ids)], (self.seq,))
            if self.source == "camera":
                src = CameraSource(period=PERIOD, n_frames=self.frames, jitter_frac=0.3,
                                   payload_shape=(self.seq,), seed=i)
            else:  # burst: the same declared rate, delivered 2x in bursts
                src = BurstSource(period=PERIOD, n_frames=self.frames, burst=4, duty=0.5,
                                  payload_shape=(self.seq,), seed=i)
            out.append((cat, DEADLINE, src))
        return out

    def dump_trace(self) -> None:
        if self.tracer is None:
            return
        self.tracer.dump_chrome_trace(self.trace)
        snap = self.tracer.snapshot()
        self.record["spans"] = snap["events"]
        print(f"trace  : {snap['events']} spans ({snap['emitted']} emitted, "
              f"{snap['evicted']} evicted) -> {self.trace}")

    def note_engine(self, name, engine, device) -> None:
        self.record["slices"][name] = {
            "decode_compiles": engine.stats["decode_compiles"],
            "prefill_compiles": engine.stats["prefill_compiles"],
            "device_busy_s": device.busy_time,
        }

    def note_cluster(self, cluster) -> dict:
        agg = cluster.aggregate_metrics()
        self.record["metrics"] = agg
        self.record["conserved"] = (agg["completed_frames"] + agg["dropped_frames"]
                                    + agg["lost_frames"] == agg["ingested_frames"])
        return agg

    def note_scheduler(self, m) -> None:
        self.record["metrics"] = {
            "completed_frames": m.completed_frames, "missed_frames": m.missed_frames,
            "miss_rate": m.miss_rate, "dropped_frames": m.dropped_frames,
            "lost_frames": m.lost_frames, "ingested_frames": m.ingested_frames,
            "jobs": m.job_count}
        self.record["conserved"] = (m.completed_frames + m.dropped_frames + m.lost_frames
                                    == m.ingested_frames)

    # -- topologies -------------------------------------------------------
    def serve_ingest(self, target, engines) -> None:
        """Stream real payloads through the gateway over ``target`` (a live
        DeepRT or a ClusterScheduler); print the ingest scorecard."""
        gw = IngestGateway(target)
        gw.tracer = self.tracer
        sessions = []
        for cat, deadline, src in self.sources():
            s = gw.register(src, cat, relative_deadline=deadline)
            where = f" @{s.slice_name}" if s.slice_name else ""
            print(f"stream {s.request_id} ({cat}): "
                  f"{'ADMIT' + where if s.state == 'active' else 'REJECT'}")
            sessions.append(s)
        print(f"\nserving live --source {self.source} "
              f"(payload bytes staged per step, zero-stall)...")
        target.run()
        active = [s for s in sessions if s.state == "active"]
        ingested = sum(s.frames_ingested for s in active)
        delivered = sum(s.frames_delivered for s in active)
        dropped = sum(s.frames_dropped for s in active)
        conserved = all(s.conserved() for s in sessions)
        self.record["sessions_conserved"] = conserved
        print(f"ingest : streams={len(active)}/{len(sessions)} "
              f"ingested={ingested} delivered={delivered} shed={dropped} "
              f"(conserved={conserved})")
        for name, eng in engines.items():
            fills = eng.staging_fills
            bps = eng.staging_bytes / fills if fills else 0.0
            print(f"  {name}: staged {eng.staging_bytes}B over {fills} steps "
                  f"({bps:.0f} B/step), host_allocs={eng.staging_host_allocs}, "
                  f"decode_compiles={eng.stats['decode_compiles']}")

    def serve_transport(self, n_slices: int) -> None:
        """The full networked path: every stream is a datagram client
        behind its own seed-derived chaotic link; the server reassembles,
        backpressures and (if a slice dies) re-homes."""
        n_slices = max(2, n_slices)
        print(f"building + profiling {n_slices} slices (per-slice §4.1 pass)...")
        cluster, slices, _gateway, transport, _binding = build_live_transport(
            self.configs, self.categories,
            slice_names=tuple(f"slice{i}" for i in range(n_slices)),
            record_payloads=False, tracer=self.tracer, device=self.device,
        )
        try:
            loop = cluster.loop
            links = []
            for i, (cat, deadline, src) in enumerate(self.sources()):
                plan = LinkPlan.from_seed(
                    self.chaos_seed + i, src.n_frames * 4,
                    p_drop=0.05, p_dup=0.05, p_reorder=0.08, p_delay=0.05,
                    reorder_hold=(0.05, 0.2),
                )
                link = SimLink(loop, transport.datagram, plan=plan)
                client = TransportSource(src, cat, deadline, link)
                ok = client.start(transport)
                ts = transport.sessions.get(client.sid)
                where = f" @{ts.session.slice_name}" if ok else ""
                print(f"stream {client.sid} ({cat}): "
                      f"{'ADMIT' + where if ok else 'REJECT'}")
                links.append(link)
            print("\nserving through the chaotic link (wall clock, zero-stall)...")
            cluster.run()
            transport.finalize_all()
            cluster.run(until=loop.now + 0.5)
            snap = json.loads(transport.status_json())
            print(f"link   : sends={sum(l.sends for l in links)} "
                  f"dropped={sum(l.dropped for l in links)} "
                  f"duplicated={sum(l.duplicated for l in links)} "
                  f"reordered={sum(l.reordered for l in links)} "
                  f"delayed={sum(l.delayed for l in links)}")
            wire_ok = True
            for sid, sess in sorted(snap["sessions"].items(), key=lambda kv: int(kv[0])):
                w = sess["wire"]
                wire_ok &= bool(w["conserved"])
                print(f"  session {sid} @{sess['slice']}: received={w['received']} "
                      f"delivered={w['delivered']} dup={w['duplicates']} "
                      f"lost={w['net_lost']} late={w['late_rejected']} "
                      f"credit={sess['credit']:.2f} downshifts={sess['downshifts']} "
                      f"conserved={w['conserved']}")
            self.record["wire_conserved"] = wire_ok
            agg = self.note_cluster(cluster)
            print(f"cluster: completed={agg['completed_frames']} "
                  f"missed={agg['missed_frames']} ({agg['miss_rate']:.1%}) "
                  f"shed={agg['dropped_frames']} lost={agg['lost_frames']} "
                  f"conserved={self.record['conserved']}")
            for name, sl in slices.items():
                self.note_engine(name, sl.engine, sl.device)
                print(f"  {name}: decode_compiles={sl.engine.stats['decode_compiles']} "
                      f"device_busy={sl.device.busy_time:.2f}s")
            self.dump_trace()
        finally:
            _close(slices)

    def serve_cluster(self, n_slices: int) -> None:
        print(f"building + profiling {n_slices} slices (per-slice §4.1 pass)...")
        cluster, slices = build_live_cluster(
            self.configs, self.categories,
            slice_names=tuple(f"slice{i}" for i in range(n_slices)),
            tracer=self.tracer, device=self.device,
        )
        try:
            if self.source:
                self.serve_ingest(cluster, {n: sl.engine for n, sl in slices.items()})
                agg = self.note_cluster(cluster)
                print(f"cluster: completed={agg['completed_frames']} "
                      f"missed={agg['missed_frames']} ({agg['miss_rate']:.1%}) "
                      f"shed={agg['dropped_frames']} "
                      f"e2e={agg['mean_e2e_latency']*1e3:.1f}ms")
            else:
                for r in generate_trace(self.trace_spec()):
                    r.start_time = 0.0
                    ok = cluster.submit_request(r)
                    where = cluster.placement.get(r.request_id, "-")
                    print(f"request {r.request_id} ({r.category}): "
                          f"{'ADMIT @' + where if ok else 'REJECT (all slices)'}")
                print("\nserving live across slices (one wall clock, zero-stall)...")
                cluster.run()
                agg = self.note_cluster(cluster)
                print(f"cluster: completed={agg['completed_frames']} "
                      f"missed={agg['missed_frames']} ({agg['miss_rate']:.1%}) "
                      f"jobs={agg['jobs']} dropped={agg['dropped_requests']}")
            for name, sl in slices.items():
                self.note_engine(name, sl.engine, sl.device)
                if self.source:
                    continue
                m, st = sl.scheduler.metrics, sl.engine.stats
                print(f"  {name}: frames={m.completed_frames} "
                      f"decode_compiles={st['decode_compiles']} "
                      f"prefill_compiles={st['prefill_compiles']} "
                      f"device_busy={sl.device.busy_time:.2f}s")
            self.dump_trace()
        finally:
            _close(slices)

    def serve_single(self) -> None:
        print("building + profiling engine (paper §4.1 offline pass)...")
        sched, engine, table = build_live_scheduler(
            self.configs, self.categories, tracer=self.tracer, device=self.device)
        try:
            if self.source:
                self.serve_ingest(sched, {"device0": engine})
                m = sched.metrics
                self.note_scheduler(m)
                print(f"DeepRT : completed={m.completed_frames} missed={m.missed_frames} "
                      f"({m.miss_rate:.1%}) shed={m.dropped_frames} "
                      f"e2e={m.mean_e2e_latency*1e3:.1f}ms "
                      f"sched-latency={m.mean_latency*1e3:.1f}ms")
                self.note_engine("device0", engine, sched.device)
                self.dump_trace()
                return
            for (mid, shape), batches in sorted(table.entries.items(), key=lambda kv: kv[0]):
                b1, b8 = batches.get(1), batches.get(8)
                print(f"  {mid} shape={shape}: E(1)={b1*1e3:.1f}ms E(8)={b8*1e3:.1f}ms")
            accepted = []
            for r in generate_trace(self.trace_spec()):
                r.start_time = 0.0
                res = sched.submit_request(r)
                print(f"request {r.request_id} ({r.category}): "
                      f"{'ADMIT' if res.admitted else 'REJECT'} (U={res.utilization:.2f})")
                if res.admitted:
                    accepted.append(copy.deepcopy(r))
            print("\nserving live (wall clock, async zero-stall dispatch)...")
            m = sched.run()
            self.note_scheduler(m)
            print(f"DeepRT : completed={m.completed_frames} missed={m.missed_frames} "
                  f"({m.miss_rate:.1%}) jobs={m.job_count} mean_batch={m.mean_batch:.2f}")
            print(f"         host stall/job={m.mean_dispatch_overhead*1e6:.0f}us "
                  f"padding_waste={m.padding_waste:.1%} "
                  f"device_busy={sched.device.busy_time:.2f}s")
            # Baseline on the same accepted trace, simulated with the
            # measured table.
            base = BATCH(table, loop=EventLoop(), batch_size=4)
            for r in accepted:
                base.submit_request(copy.deepcopy(r))
            bm = base.run()
            self.record["batch4"] = {
                "completed_frames": bm.completed_frames, "missed_frames": bm.missed_frames,
                "miss_rate": bm.miss_rate, "jobs": bm.job_count}
            self.record["accepted"] = len(accepted)
            print(f"BATCH-4: completed={bm.completed_frames} missed={bm.missed_frames} "
                  f"({bm.miss_rate:.1%}) jobs={bm.job_count} mean_batch={bm.mean_batch:.2f}")
            self.note_engine("device0", engine, sched.device)
            self.dump_trace()
        finally:
            sched.device.close()


def _close(slices) -> None:
    """Stop every slice's device: its waiter thread holds the engine."""
    for sl in slices.values():
        sl.device.close()


def serve(configs: Dict[str, ModelConfig], requests: int = 8, seq: int = 48,
          frames: int = 15, slices: int = 1, source: Optional[str] = None,
          transport: bool = False, chaos_seed: int = 7, trace: Optional[str] = None,
          device: str = "cuda") -> dict:
    """Serve ``configs`` (model id -> config) in the topology the
    arguments select, as the CLI's flags do, printing the scorecards.
    Returns the run's record: ``metrics``, ``conserved``, per slice (or
    ``device0``) its decode and prefill builds, ``batch4`` beside DeepRT on
    one device without a source, ``spans`` with a trace."""
    run = _Run(configs, requests, seq, frames, source, chaos_seed, trace, device)
    if transport:
        # Transport clients need payload sources.
        run.source = run.source or "camera"
        run.serve_transport(slices)
    elif slices > 1:
        run.serve_cluster(slices)
    else:
        run.serve_single()
    run.record["topology"] = ("transport" if transport else
                              f"{slices} slices" if slices > 1 else "single") + (
        f", source {run.source}" if run.source else "")
    return run.record


def main(argv=None) -> dict:
    args = parse_args(argv)
    return serve({a: tiny(a) for a in ARCHS}, requests=args.requests, seq=args.seq,
                 frames=args.frames, slices=args.slices, source=args.source,
                 transport=args.transport, chaos_seed=args.chaos_seed, trace=args.trace,
                 device=args.device)


if __name__ == "__main__":
    main()
