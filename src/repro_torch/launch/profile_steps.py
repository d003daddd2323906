"""Where a served step's time goes, on the card.

Builds the engine over granite-3-2b at full width (random weights from a
seed, as ``chip_smoke.py`` does), warms up the decode step and the
prefill buckets, then for each step reports:

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

MID = "granite-3-2b"
RUNS = 10
TOP = 12


def _step(engine, kind, seq, batch):
    return engine.dispatch(MID, (seq,), batch, kind)


def profile(engine, kind, seq, batch):
    for _ in range(3):
        _step(engine, kind, seq, batch).wait()
    walls, enqueues = [], []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = _step(engine, kind, seq, batch)
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
            _step(engine, kind, seq, batch).wait()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    wall = statistics.median(walls)
    kernels = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:TOP]
    return {
        "kind": kind, "seq": seq, "batch": batch,
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
    cfg = get_config(MID)
    engine = InferenceEngine({MID: cfg}, seed=0, max_slots=8, device="cuda")
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{cfg.n_layers} layers {cfg.param_dtype}")
    for kind, seq, batch in (("decode", 2048, 8), ("prefill", 512, 1), ("prefill", 512, 8)):
        print(json.dumps(profile(engine, kind, seq, batch)))


if __name__ == "__main__":
    main()
