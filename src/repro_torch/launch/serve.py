"""Serving launcher: DeepRT live over the PyTorch models.

Builds an InferenceEngine over reduced configs on ``--device`` (CUDA by
default), profiles it (paper §4.1), then serves a synthesized
multi-tenant request trace through the full DeepRT stack (admission ->
DisBatcher -> EDF -> engine) on a wall clock.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
      --requests 12 --frames 20
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import tiny
from repro_torch.core import TraceSpec, generate_trace
from repro_torch.serving.batcher_bridge import build_live_scheduler

PORTED_ARCHS = ("granite-3-2b", "rwkv6-1.6b", "recurrentgemma-9b")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="granite-3-2b,rwkv6-1.6b")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--mean-period", type=float, default=0.25)
    ap.add_argument("--mean-deadline", type=float, default=0.5)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    arch_ids = args.archs.split(",")
    unported = [a for a in arch_ids if a not in PORTED_ARCHS]
    if unported:
        ap.error(f"--archs {unported} not ported yet; ported: {list(PORTED_ARCHS)}")
    configs = {a: tiny(a) for a in arch_ids}
    categories = [(a, (args.seq,), "prefill") for a in arch_ids]
    print(f"profiling engine on {args.device} (paper §4.1 offline pass)...")
    sched, engine, table = build_live_scheduler(
        configs, categories, device=args.device
    )
    print(table.to_json())

    spec = TraceSpec(
        mean_period=args.mean_period,
        mean_deadline=args.mean_deadline,
        n_requests=args.requests,
        frames_per_request=(args.frames, args.frames),
        models=tuple(arch_ids),
        shapes=((args.seq,),),
        seed=1,
    )
    admitted = 0
    for r in generate_trace(spec):
        r.start_time = 0.0
        res = sched.submit_request(r)
        admitted += res.admitted
        print(
            f"request {r.request_id} ({r.category}): "
            f"{'ADMIT' if res.admitted else 'REJECT'} "
            f"(phase {res.phase}, U={res.utilization:.2f})"
        )
    print(f"admitted {admitted} requests; serving...")
    m = sched.run()
    print(
        f"completed={m.completed_frames} missed={m.missed_frames} "
        f"miss_rate={m.miss_rate:.3f} jobs={m.job_count} "
        f"mean_batch={m.mean_batch:.2f} throughput={m.throughput:.1f} fps"
    )


if __name__ == "__main__":
    main()
