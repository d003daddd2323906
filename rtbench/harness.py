"""One run of one cell: set-up, the measured window, the check, the line.

Everything runs in one process on one card. The entry the window drives
is the port's ingest gateway (``repro_torch.ingest.IngestGateway``) over
a one-slice live cluster (``build_live_cluster``, slice ``slice0``):
gateway, placement, admission, DisBatcher, EDF worker, ``AsyncDevice``,
the engine's graph replays, the models, the kernels, the device.

Set-up (``setup_s``, from process start to the first frame due): import,
the kernel libraries (built into the checkout by the first run), the
weights made on the device from the seed, the cluster with its profiled
WCETs and captured graphs, and the streams' registration (admission).
The window opens when the first frame is due and lasts ``--seconds``;
every frame of the mix is due inside it (``traffic/plan.py``). The loop
then runs until every frame has completed or been shed.

The harness wraps the slice device's ``dispatch_fn`` to keep what each
job served: a prefill's next tokens, and a decode step's argmax over
each row's logits (one small launch after the step), with the rows and
tokens each stream consumed, and the wall clock at each dispatch. With
``--trace 1`` it attaches the port's ``FrameTracer`` and, once the window
has closed, traces the device with ``torch.profiler`` while the same
traffic goes on for ``TRACE_TAIL_S`` more seconds (see ``TRACE_S``).
"""
from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from rtbench import check, devtrace, framelog, spec
from rtbench.reference import weights
from rtbench.traffic import plan

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACER_CAPACITY = 4_000_000
# The device trace: starting the profiler stalls the host for seconds,
# tracing every kernel slows each graph launch, and stopping it flushes
# hundreds of thousands of events; inside the window all three would
# make the scheduler shed what it otherwise serves. So a traced run's
# traffic goes on past the window: the profiler starts as the window
# closes, the trace is read over TRACE_S seconds from TRACE_SETTLE_S
# after that, and the window's own per-layer numbers stay untraced.
TRACE_SETTLE_S = 4.0
TRACE_S = 3.0
TRACE_TAIL_S = TRACE_SETTLE_S + TRACE_S + 1.0
DRAIN_S = 60.0  # how long past the window the loop may run to finish frames


@dataclass
class JobRecord:
    n: int
    kind: str
    length: int  # the category's sequence length
    real_rows: int
    bucket: int
    host_ns: int  # wall clock at dispatch
    release_t: float  # loop clock at the job's release
    frames: List[Tuple[int, int]]  # (rid, index) in the job's order
    shrunk: bool = False  # ran below its category's shape (the adaptation's crop)
    decode_rows: List[Tuple[int, int, int]] = field(default_factory=list)  # (rid, row, token)
    ctx: List[int] = field(default_factory=list)  # cache length of each active row
    served: object = None  # device tensor: ids (bucket,) or row argmax (rows,)
    served_host: object = None


def merged(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is the port)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def dims_of(port: Dict) -> Dict:
    return {k: port.get(k) for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                                     "head_dim", "d_ff", "vocab_size", "rope_theta")}


def build_capture(sl, kinds: Dict, log: List[JobRecord], consumed: Dict[int, int]):
    """Wrap the slice device's dispatch: keep what each job served."""
    inner = sl.device.dispatch_fn
    loop = sl.scheduler.loop

    def spy(job):
        n = len(log)
        kind = kinds[(job.category.model_id, tuple(job.category.shape_key))]
        rec = JobRecord(
            n=n, kind=kind, length=int(job.shape_key[0]), real_rows=job.batch_size,
            bucket=0, host_ns=time.time_ns(),
            release_t=float(getattr(job, "release_time", loop.now)),
            frames=[(f.request_id, f.index) for f in job.frames],
            shrunk=tuple(job.shape_key) != tuple(job.category.shape_key))
        if kind == "decode":
            seen = set()
            for f in job.frames:
                lease = sl.leases.get(f.request_id)
                if lease is None or f.request_id in seen:
                    continue  # a stream's earliest frame is the one its row consumes
                seen.add(f.request_id)
                row = lease[2][0]
                rec.decode_rows.append((f.request_id, row, int(np.asarray(f.payload))))
                consumed[f.request_id] = consumed.get(f.request_id, 0) + 1
                rec.ctx.append(consumed[f.request_id])
        handle = inner(job)
        out = handle.outputs
        rec.bucket = int(getattr(handle, "bucket_batch", 0))
        rec.served = out.argmax(-1) if kind == "decode" else out
        log.append(rec)
        return handle

    sl.device.dispatch_fn = spy


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_process0: Optional[float] = None, tiny: bool = False, control: bool = False,
        fault: Optional[Callable] = None, mix: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's dict and the numbers compared.
    ``tiny``: the configuration's ``tiny`` sizes (CPU tests). ``control``:
    also read the float8 control on the same sample. ``fault(slices)``
    runs on the built cluster before registration (tests: break the timed
    path underneath, or pin the WCETs). ``mix`` replaces the cell's
    traffic mix (the sweep)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import Category
    from repro_torch.core.telemetry import FrameTracer
    from repro_torch.ingest import IngestGateway
    from repro_torch.serving.batcher_bridge import build_live_cluster

    t_process0 = time.time() if t_process0 is None else t_process0
    cfg = cell.config_spec()
    if tiny:
        cfg = merged(cfg, cfg["tiny"])
    mix = cell.traffic_mix() if mix is None else mix
    port, serving = dict(cfg["port"]), cfg["serving"]
    mcfg = ModelConfig(**{**port, "block_pattern": tuple(port["block_pattern"])})
    mid = mcfg.arch_id
    family = spec.family(cfg["block_family"], cell.bench_dir)
    dims = dims_of({**port, "rope_theta": mcfg.rope_theta})
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build(serving.get("kernels", _build.KERNELS))
    torch.manual_seed(int(seed) % (1 << 63))
    tree = weights.make(family, dims, seed, dev, mcfg.dtype)

    streams = plan.streams(mix, seed, seconds + (TRACE_TAIL_S if trace else 0.0),
                           mcfg.vocab_size)
    decode_seq = int(serving["decode_seq"])
    longest = max((s.source.n_frames for s in streams if s.kind == "decode"), default=0)
    if longest >= decode_seq:
        raise ValueError(f"a decode stream of {longest} tokens does not fit the arena's "
                         f"{decode_seq} positions: shorten the window or lengthen decode_seq")
    cats, kinds = [], {}
    for s in streams:
        shape = (decode_seq,) if s.kind == "decode" else (s.length,)
        key = (mid, shape)
        if key not in kinds:
            kinds[key] = s.kind
            cats.append((mid, shape, s.kind))
    cluster, slices = build_live_cluster(
        {mid: mcfg}, cats, slice_names=("slice0",), batch_sizes=tuple(serving["batch_sizes"]),
        profile_runs=int(serving["profile_runs"]), nonrt_cap=int(serving["arena_rows"]),
        device=dev, params={mid: tree})
    sl = slices["slice0"]
    loop = cluster.loop
    log: List[JobRecord] = []
    consumed: Dict[int, int] = {}
    build_capture(sl, kinds, log, consumed)
    if fault is not None:
        fault(slices)
    gateway = IngestGateway(cluster)
    tracer = None
    if trace:
        tracer = FrameTracer(capacity=TRACER_CAPACITY)
        cluster.attach_tracer(tracer)
        gateway.tracer = tracer

    # Registration: every stream's admission test, then its arrivals at
    # the window's open plus its phase plus its plan's offsets.
    # Admission's imitator works through every planned frame: on the H100's
    # host, registration took 60-80 us a frame (1.3-1.6 s for granite.chat's
    # 19,556); the lead allows about twice that.
    lead = 0.5 + 150e-6 * sum(st.source.n_frames for st in streams)
    t_open = loop.now + lead
    sessions, by_rid = [], {}
    for s in streams:
        shape = (decode_seq,) if s.kind == "decode" else (s.length,)
        sess = gateway.register(s.source, Category(mid, shape), relative_deadline=s.deadline,
                                start_in=t_open + s.phase - loop.now, schedule_arrivals=False)
        sessions.append((s, sess))
        by_rid[sess.request_id] = s
    registration_s = loop.now - (t_open - lead)
    late = loop.now - (t_open - 0.05)
    if late > 0:
        raise RuntimeError(f"registration ran {late:.3f} s past its lead of {lead:.3f} s")
    prio = getattr(loop, "PRIO_ARRIVAL", 0)
    outcome: Dict[Tuple[int, int], str] = {}
    for s, sess in sessions:
        if sess.state != "active":
            continue
        for i, fp in enumerate(s.source.plan()):
            t = t_open + s.phase + fp.offset

            def deliver(sess=sess, i=i, payload=fp.payload):
                outcome[(sess.request_id, i)] = gateway.deliver(sess, i, payload)

            loop.schedule(t, deliver, priority=prio)
    open_wall = time.time() + (t_open - loop.now)
    t_close = t_open + seconds
    counters: Dict[str, Dict] = {}
    loop.schedule(t_open, lambda: counters.update(start=_counters(sl.scheduler.metrics)),
                  priority=prio)
    loop.schedule(t_close, lambda: counters.update(end=_counters(sl.scheduler.metrics)),
                  priority=prio)
    prof = None
    trace_at = (t_close + TRACE_SETTLE_S, TRACE_S)
    setup_s = open_wall - t_process0

    if trace:
        acts = [torch.profiler.ProfilerActivity.CUDA if dev.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=acts)
        loop.schedule(t_close + 0.01, prof.start, priority=prio)
        loop.schedule(trace_at[0] + trace_at[1] + 0.05, prof.stop, priority=prio)
    loop_to_ns = time.time_ns() - int(loop.now * 1e9)
    cluster.run(until=t_open + seconds + DRAIN_S)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    # What the window served, on the host; then the program's state goes.
    for rec in log:
        rec.served_host = rec.served.cpu().numpy() if rec.served is not None else None
        rec.served = None
    metrics = sl.scheduler.metrics
    records = metrics.frame_records
    shape_changes = sl.scheduler.adaptation.shape_changes
    sl_penalties = dict(sl.scheduler.adaptation.penalties)
    table = sl.spec.table
    wcet = {key: ({str(b): w for b, w in table.entries[key].items()} if key in table.entries
                  else table.flat_entries.get(key)) for key in kinds}
    frames: List[framelog.Frame] = []
    shrunk = {key for r in log if r.shrunk for key in r.frames}
    offered = admitted = 0
    for s, sess in sessions:
        offered += 1
        ok = sess.state in ("active", "closed")
        admitted += int(ok)
        for i, fp in enumerate(s.source.plan()):
            if t_open + s.phase + fp.offset >= t_close:
                break  # the traced run's traffic past the window
            rec = records.get((sess.request_id, i)) if ok else None
            frames.append(framelog.Frame(
                cls=s.cls, rid=sess.request_id, index=i, tokens=s.length,
                due=t_open + s.phase + fp.offset, deadline=s.deadline, admitted=ok,
                completion=None if rec is None else rec[2],
                shed=outcome.get((sess.request_id, i)) == "shed",
                degraded=(sess.request_id, i) in shrunk))
    summary = framelog.summarize(frames, seconds)
    by_class = framelog.by_class(frames)
    dtrace = None
    if prof is not None:
        w0 = loop_to_ns + int(trace_at[0] * 1e9)
        release = {r.n: loop_to_ns + int(r.release_t * 1e9) for r in log}
        dtrace = devtrace.reduce(prof.profiler.kineto_results.events(),
                                 (w0, w0 + int(trace_at[1] * 1e9)),
                                 spec.kernel_costs(cell.bench_dir),
                                 [(r.host_ns, r.n) for r in log], release)
        del prof
    reading = spec.Reading(cell=cell, frames=frames, offered=offered, admitted=admitted,
                           counters=_delta(counters["start"], counters["end"]),
                           window=(t_open, t_close), jobs=log,
                           tracer=tracer, trace=dtrace, family=family,
                           model={**dims, "decode_seq": decode_seq,
                                  "kernels": list(serving.get("kernels", ()))})
    layer = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.bench_dir).read(reading)
            if value is not None:
                layer[m["name"]] = {"value": float(value), "unit": m["unit"]}
    mem_peak = mem_reserved = None
    if dev.type == "cuda":
        mem_peak = torch.cuda.max_memory_allocated(dev)
        mem_reserved = torch.cuda.max_memory_reserved(dev)
    sl.device.close()
    del cluster, slices, sl, gateway, reading
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = check.run_check(family, tree, dims, log, by_rid, cfg["check"], seed, dev,
                              control=control)
    correct, rows = check.verdict(numbers, cfg["check"]["limits"])
    frames_detail = {k: v.pop("frames", None) for k, v in numbers.items()}
    # A frame of an admitted stream that was neither shed nor answered by
    # the end of the drain is an answer that never came.
    rows.append(("lost_frames", int(summary["failed"]), 0))
    if summary["failed"] > 0 or summary["admitted_frames"] == summary["missed"]:
        correct = False
    check_s = time.perf_counter() - t_check

    e2e = {"goodput_tok_s": summary["goodput_tok_s"], "setup_s": setup_s}
    if "p95_latency_ms" in summary:
        e2e["p95_latency_ms"] = summary["p95_latency_ms"]
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if trace:
        out_metrics = layer
    else:
        out_metrics = {k: {"value": float(v), "unit": units[k]} for k, v in e2e.items()
                       if k in units}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(mem_peak or 0)}
    if dtrace is not None:
        dev_info["busy_s"] = dtrace.busy_s
        dev_info["window_s"] = dtrace.window_s
    line = {"correct": bool(correct), "attempted": int(summary["attempted"]),
            "failed": int(summary["failed"]), "metrics": out_metrics, "device": dev_info}
    if dtrace is not None:
        line["breakdown"] = {"device_ops": dtrace.device_ops, "idle_gaps": dtrace.idle_gaps}
    line["streams"] = {"offered": offered, "admitted": admitted}
    line["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    extra = {
        "e2e": e2e, "summary": summary, "offered": offered, "admitted": admitted,
        "numbers": numbers, "check_s": check_s, "gap_frames": frames_detail, "memory_reserved_bytes": mem_reserved,
        "jobs": len(log), "registration_s": registration_s,
        "wcet": {f"{k[1][0]}": v for k, v in wcet.items()},
        "shape_changes": shape_changes, "shrunk_jobs": sum(r.shrunk for r in log),
        "trace_kernels": dtrace.kernel_names if dtrace else None,
        "admitted_by_class": _admitted_by_class(sessions), "by_class": by_class,
        "penalties": {str(k): v for k, v in sl_penalties.items()},
    }
    return {"line": line, "extra": extra}


COUNTERS = ("dropped_frames", "delivered_frames", "job_count", "real_rows",
            "dispatch_overhead_sum", "dispatch_count")


def _counters(metrics) -> Dict[str, float]:
    return {k: getattr(metrics, k) for k in COUNTERS}


def _delta(start: Dict, end: Dict) -> Dict[str, float]:
    """The slice's counters over the window."""
    return {k: end[k] - start[k] for k in COUNTERS}


def _admitted_by_class(sessions) -> Dict[str, List[int]]:
    out: Dict[str, List[int]] = {}
    for s, sess in sessions:
        a = out.setdefault(s.cls, [0, 0])
        a[0] += int(sess.state in ("active", "closed"))
        a[1] += 1
    return out


def compared_lines(line: Dict) -> List[str]:
    return [f"compared {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in line["compared"].items()]


def main(argv: List[str], t_process0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="rtbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rtbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_process0)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out["extra"], default=str), file=sys.stderr)
    for text in compared_lines(out["line"]):
        print(text, file=sys.stderr)
    print(json.dumps(out["line"]), flush=True)
    return 0
