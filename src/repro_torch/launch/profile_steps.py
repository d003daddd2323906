"""Where a served step's time goes, on the card.

Builds one engine over the ported models at full width, granite-3-2b,
rwkv6-1.6b and recurrentgemma-9b (random weights from a seed, as
``chip_smoke.py`` does), warms up each model's decode step (seq 2048;
4096 for recurrentgemma, whose 2048-slot ring is then narrower than the
sequence) and its prefill buckets, then for each step reports:

- wall ms per step (host clock around dispatch + wait, median of RUNS
  unprofiled steps);
- host enqueue ms (dispatch returning, before the device finishes);
- device busy ms per step (``torch.profiler`` CUDA time, mean of three
  profiled steps) and the device's idle share of the step,
  1 - busy / unprofiled wall median (not clamped: a busy time above the
  wall shows as a negative share, a measurement fault);
- the TOP kernels by device time.

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
RUNS = 10
TOP = 12


def _step(engine, mid, kind, seq, batch):
    return engine.dispatch(mid, (seq,), batch, kind)


def profile(engine, mid, kind, seq, batch):
    for _ in range(3):
        _step(engine, mid, kind, seq, batch).wait()
    walls, enqueues = [], []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = _step(engine, mid, kind, seq, batch)
        t1 = time.perf_counter()
        h.wait()
        t2 = time.perf_counter()
        enqueues.append((t1 - t0) * 1e3)
        walls.append((t2 - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n = 3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            _step(engine, mid, kind, seq, batch).wait()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    wall = statistics.median(walls)
    kernels = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:TOP]
    return {
        "model": mid, "kind": kind, "seq": seq, "batch": batch,
        "wall_ms_median": wall, "wall_ms_max": max(walls),
        "enqueue_ms_median": statistics.median(enqueues),
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall,
        "top_kernels": [
            {"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / n,
             "calls_per_step": e.count / n}
            for e in kernels
        ],
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_steps measures the card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfgs = {mid: get_config(mid) for mid in DECODE_SEQ}
    engine = InferenceEngine(cfgs, seed=0, max_slots=8, device="cuda")
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          + "; ".join(f"{m} {c.n_layers} layers {c.param_dtype}" for m, c in cfgs.items()))
    for mid, dec_seq in DECODE_SEQ.items():
        steps = (("decode", dec_seq, 8), ("prefill", PREFILL_SEQ, 1), ("prefill", PREFILL_SEQ, 8))
        for kind, seq, batch in steps:
            print(json.dumps(profile(engine, mid, kind, seq, batch)), flush=True)


if __name__ == "__main__":
    main()
