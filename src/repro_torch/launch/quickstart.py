"""Quickstart: the DeepRT scheduler on the virtual clock (the twin of
``examples/quickstart.py``).

Builds a WCET profile table by hand, admits a few periodic inference
requests through the two-phase Admission Control Module, and runs the
DisBatcher + EDF pipeline on the virtual clock. It touches no device.

  PYTHONPATH=src python -m repro_torch.launch.quickstart
"""
from __future__ import annotations

from repro_torch.core import Category, DeepRT, Metrics, ProfileTable, Request

# (period, relative deadline) of each request, seconds.
REQUESTS = ((0.033, 0.1), (0.05, 0.08), (0.02, 0.15))


def resnet50_table() -> ProfileTable:
    """The hand-made profile table (paper §4.1): (model, shape, batch) ->
    worst-case seconds, batching at 0.35 of the batch-1 cost an image."""
    table = ProfileTable()
    for batch in [1, 2, 4, 8, 16, 32]:
        table.record("resnet50", (3, 224, 224), batch, 0.0035 * (1 + 0.35 * (batch - 1)))
        table.record("resnet50", (3, 112, 112), batch, 0.0012 * (1 + 0.35 * (batch - 1)))
    return table


def main() -> Metrics:
    """Admit the three requests, run to completion and print what the
    reference's example prints; raises if an admitted frame missed."""
    sched = DeepRT(resnet50_table())
    cat = Category(model_id="resnet50", shape_key=(3, 224, 224))
    for i, (period, deadline) in enumerate(REQUESTS):
        req = Request(category=cat, period=period, relative_deadline=deadline, n_frames=90)
        result = sched.submit_request(req)
        print(
            f"request {i}: period={period*1e3:.0f}ms deadline={deadline*1e3:.0f}ms -> "
            f"{'ADMITTED' if result.admitted else 'REJECTED'} "
            f"(phase {result.phase}, utilization {result.utilization:.2f})"
        )
    metrics = sched.run()
    print(
        f"\ncompleted={metrics.completed_frames} frames, "
        f"missed={metrics.missed_frames} deadlines "
        f"({metrics.miss_rate:.1%} miss rate)\n"
        f"jobs executed={metrics.job_count}, mean batch={metrics.mean_batch:.2f}, "
        f"throughput={metrics.throughput:.1f} frames/s"
    )
    if metrics.missed_frames:
        raise AssertionError("admitted requests must meet deadlines")
    print("Theorem 1 held: every admitted frame met its deadline.")
    return metrics


if __name__ == "__main__":
    main()
