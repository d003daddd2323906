"""Where a served step's time goes, on the card.

Builds one engine over the ported models at full width, granite-3-2b,
rwkv6-1.6b and recurrentgemma-9b (random weights from a seed, as
``chip_smoke.py`` does), with decode chunks up to 8 steps. Per model it
warms up the decode step (seq 2048; 4096 for recurrentgemma, whose
2048-slot ring is then narrower than the sequence), its chunks of 2, 4
and 8 steps, and its prefill buckets, then for each reports:

- the decode step eagerly (the step's body run outside its CUDA graph,
  as every decode step ran before the graphs), then as a graph replay;
  k-step decode chunks (one replay each); prefill at batch 1 and 8
  (eager);
- wall ms per dispatch (host clock around dispatch + wait, median of RUNS
  unprofiled dispatches) and per step (wall / k);
- host enqueue ms (dispatch returning, before the device finishes);
- event ms: CUDA events recorded on the stream before the dispatch and
  after it (median of the same RUNS): the device's span of the dispatch;
- device busy ms per dispatch and per step (``torch.profiler`` CUDA time,
  mean of three profiled dispatches) and the device's idle share,
  1 - busy / unprofiled wall median (not clamped: a busy time above the
  wall shows as a negative share, a measurement fault);
- the TOP kernels by device time.

Then per model, eight decode steps four ways, each under one handle:
8 back-to-back replays of the step graph, 4 of the 2-step chunk graph,
2 of the 4-step one, and 1 replay of the 8-step one. The four take
turns in every one of RUNS rounds (so drift in clocks or the host hits
them alike). Per way: wall and event span per step (medians), device
busy per step, and from one profiled dispatch the gaps between
consecutive device activities: their sum per step, split over the
dispatch's eight eighths (by activity index), their median and largest,
the host's time inside ``cudaGraphLaunch``, and how much of the gap lies
before the last ``cudaGraphLaunch`` returns (a host that launches slower
than the device drains would put the gaps there). Each way also runs
held: a device sleep of HOLD_CYCLES clock cycles is enqueued first, so
every launch has returned before the device reaches the graphs; the
event span after the sleep then shows the graphs' own execution, with
no waiting on the host (the sleep's span and the host's enqueue time are
reported beside it, to show the sleep outlasted the launches).

  PYTHONPATH=src python -m repro_torch.launch.profile_steps
"""
from __future__ import annotations

import json
import statistics
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.serving.engine import InferenceEngine

DECODE_SEQ = {"granite-3-2b": 2048, "rwkv6-1.6b": 2048, "recurrentgemma-9b": 4096}
PREFILL_SEQ = 512
CHUNKS = (2, 4, 8)
RUNS = 10
TOP = 12
HOLD_CYCLES = 200_000_000  # about 0.1 s at the H100's 1.98 GHz boost clock


def _dispatcher(engine, mid, kind, seq, batch, k):
    """A callable that enqueues one dispatch of the row and returns
    something with ``wait()``."""
    if kind == "decode_eager":
        step = engine._decode_fn(mid, seq)
        tok = torch.zeros(batch, dtype=torch.int32, device=engine.device)
        cur, active = engine._prefix_mode_inputs(mid, seq, batch, "dispatch")
        return lambda: step(tok, cur, active)[0]
    if k > 1:
        return lambda: engine.decode_chunk(mid, (seq,), batch, k)
    return lambda: engine.dispatch(mid, (seq,), batch, kind)


def _wait(out):
    if hasattr(out, "wait"):
        return out.wait()
    torch.cuda.synchronize()
    return out


def profile(engine, mid, kind, seq, batch, k=1):
    run = _dispatcher(engine, mid, kind, seq, batch, k)
    for _ in range(3):
        _wait(run())
    walls, enqueues, spans = [], [], []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        h = run()
        end.record()
        t1 = time.perf_counter()
        _wait(h)
        end.synchronize()
        t2 = time.perf_counter()
        enqueues.append((t1 - t0) * 1e3)
        walls.append((t2 - t0) * 1e3)
        spans.append(start.elapsed_time(end))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n = 3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            _wait(run())
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    wall = statistics.median(walls)
    kernels = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:TOP]
    return {
        "model": mid, "kind": kind, "seq": seq, "batch": batch, "steps": k,
        "wall_ms_median": wall, "wall_ms_max": max(walls), "wall_ms_per_step": wall / k,
        "enqueue_ms_median": statistics.median(enqueues),
        "event_ms_median": statistics.median(spans),
        "device_busy_ms": busy_ms, "device_busy_ms_per_step": busy_ms / k,
        "device_idle_share": 1.0 - busy_ms / wall,
        "top_kernels": [
            {"name": e.key[:90], "ms_per_dispatch": e.self_device_time_total / 1e3 / n,
             "calls_per_dispatch": e.count / n}
            for e in kernels
        ],
    }


def _gap_profile(prof, steps):
    """Gaps between consecutive device activities of one profiled
    dispatch, and where they sit against the host's graph launches."""
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    launches = [e for e in prof.events() if e.name == "cudaGraphLaunch"]
    launch_end = max((e.time_range.end for e in launches), default=None)
    gaps = [max(0.0, b.time_range.start - a.time_range.end) for a, b in zip(dev, dev[1:])]
    parts = [0.0] * 8
    before_launch_end = 0.0
    for i, (g, b) in enumerate(zip(gaps, dev[1:])):
        parts[min(7, 8 * i // max(1, len(gaps)))] += g
        if launch_end is not None and b.time_range.start <= launch_end:
            before_launch_end += g
    ordered = sorted(gaps) or [0.0]
    return {
        "device_activities": len(dev),
        "gap_ms_per_step": sum(gaps) / 1e3 / steps,
        "gap_ms_by_eighth": [g / 1e3 for g in parts],
        "gap_us_median": statistics.median(ordered),
        "gap_us_max": ordered[-1],
        "graph_launches": len(launches),
        "graph_launch_host_ms": sum(e.time_range.elapsed_us() for e in launches) / 1e3,
        "gap_ms_before_last_launch_returns": before_launch_end / 1e3,
    }


def eight_steps(engine, mid, seq, batch):
    """Eight decode steps as 8 x k=1, 4 x k=2, 2 x k=4 and 1 x k=8
    replays, each way under one handle, taking turns."""
    ways = {}
    for k in (1, 2, 4, 8):
        one = _dispatcher(engine, mid, "decode", seq, batch, k)

        def run(one=one, n=8 // k):
            for _ in range(n - 1):
                one()
            return one()

        ways[k] = run
    for run in ways.values():
        for _ in range(2):
            _wait(run())
    walls, enqueues, spans = ({k: [] for k in ways} for _ in range(3))
    held, sleeps = {k: [] for k in ways}, {k: [] for k in ways}
    for _ in range(RUNS):
        for k, run in ways.items():
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            h = run()
            end.record()
            enqueues[k].append((time.perf_counter() - t0) * 1e3)
            _wait(h)
            end.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
            spans[k].append(start.elapsed_time(end))
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            torch.cuda._sleep(HOLD_CYCLES)
            ev[1].record()
            h = run()
            ev[2].record()
            _wait(h)
            ev[2].synchronize()
            sleeps[k].append(ev[0].elapsed_time(ev[1]))
            held[k].append(ev[1].elapsed_time(ev[2]))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = []
    for k, run in ways.items():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            _wait(run())
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        rows.append({
            "model": mid, "kind": "decode_8_steps", "seq": seq, "batch": batch,
            "way": f"{8 // k} x k={k}",
            "wall_ms_per_step": statistics.median(walls[k]) / 8,
            "event_ms_per_step": statistics.median(spans[k]) / 8,
            "enqueue_ms": statistics.median(enqueues[k]),
            "held_event_ms_per_step": statistics.median(held[k]) / 8,
            "hold_ms_min": min(sleeps[k]),
            "device_busy_ms_per_step": busy / 8,
            **_gap_profile(prof, 8),
        })
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_steps measures the card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfgs = {mid: get_config(mid) for mid in DECODE_SEQ}
    engine = InferenceEngine(cfgs, seed=0, max_slots=8, chunk_depth=max(CHUNKS),
                             device="cuda")
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          + "; ".join(f"{m} {c.n_layers} layers {c.param_dtype}" for m, c in cfgs.items()))
    for mid, dec_seq in DECODE_SEQ.items():
        rows = [("decode_eager", dec_seq, 8, 1), ("decode", dec_seq, 8, 1)]
        rows += [("decode", dec_seq, 8, k) for k in CHUNKS]
        rows += [("prefill", PREFILL_SEQ, 1, 1), ("prefill", PREFILL_SEQ, 8, 1)]
        for kind, seq, batch, k in rows:
            print(json.dumps(profile(engine, mid, kind, seq, batch, k)), flush=True)
    for mid, dec_seq in DECODE_SEQ.items():
        for row in eight_steps(engine, mid, dec_seq, 8):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
