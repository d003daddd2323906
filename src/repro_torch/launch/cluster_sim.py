"""Pod-scale DeepRT on the virtual clock: a multi-slice cluster with a
failure, a straggler and elastic re-admission (the twin of
``examples/cluster_sim.py``).

Four slices serve a multi-tenant trace; at t = 5 s one slice fails (its
requests re-admit elsewhere) and at t = 8 s another degrades 3x (its
WCET table rescales, future admissions see the reduced capacity;
in-flight overruns drain through the paper's adaptation machinery). It
touches no device.

``paper_table`` is the port's own copy of the reference benchmarks'
WCET table, calibrated to the paper's measurements (Table 1's batch-1
times on the RTX 2080, Fig 2c's batching slope): E(model, resolution, b)
= (a + a * slope * (b - 1)) * pixel_scale.

  PYTHONPATH=src python -m repro_torch.launch.cluster_sim
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core import (
    ClusterScheduler,
    ExecutionModel,
    ProfileTable,
    SliceSpec,
    TraceSpec,
    generate_trace,
)

# Paper Table 1 "-" column: solo execution time at batch 1 (seconds).
PAPER_BATCH1 = {
    "resnet50": 0.0035,
    "resnet101": 0.0064,
    "resnet152": 0.0090,
    "vgg16": 0.0045,
    "vgg19": 0.0053,
    "inception_v3": 0.0093,
    "mobilenet_v2": 0.0020,
}
# Marginal per-image cost as a fraction of the batch-1 cost (Fig 2c shows
# sub-linear batching: batch 8 is about 3-4x batch 1).
BATCH_SLOPE = 0.35

RESOLUTIONS = [(3, 224, 224), (3, 240, 352), (3, 480, 854), (3, 1080, 1920)]


def pixel_scale(shape: Tuple[int, ...]) -> float:
    return (shape[1] * shape[2]) / (224.0 * 224.0)


def paper_table(models=None, resolutions=None, max_batch: int = 256) -> ProfileTable:
    """Every model x resolution, and each resolution halved (the
    adaptation module's reduced shapes), at batches 1, 2, 4, ...,
    ``max_batch``."""
    table = ProfileTable()
    models = models or list(PAPER_BATCH1)
    resolutions = resolutions or RESOLUTIONS
    for m in models:
        a = PAPER_BATCH1[m]
        for shape in resolutions:
            for res in [shape, (shape[0], shape[1] // 2, shape[2] // 2)]:
                sc = pixel_scale(res)
                b = 1
                while b <= max_batch:
                    table.record(m, res, b, (a + a * BATCH_SLOPE * (b - 1)) * max(sc, 0.05))
                    b *= 2
    return table


def main() -> Dict[str, float]:
    """Run the scenario, printing what the reference's example prints;
    returns the cluster's aggregate metrics."""
    cluster = ClusterScheduler(execution=ExecutionModel(actual_fn=lambda j, w: 0.95 * w))
    for i in range(4):
        cluster.add_slice(SliceSpec(name=f"slice{i}", table=paper_table()))
    trace = generate_trace(
        TraceSpec(
            mean_period=0.1,
            mean_deadline=0.25,
            n_requests=40,
            frames_per_request=(200, 400),
            models=("resnet50", "resnet101", "vgg16", "mobilenet_v2"),
            shapes=((3, 224, 224), (3, 240, 352)),
            seed=11,
            mean_interarrival=0.2,
        )
    )
    placed = sum(cluster.submit_request(r) for r in trace)
    print(f"placed {placed}/{len(trace)} requests across 4 slices")
    print({name: sum(1 for s in cluster.placement.values() if s == name)
           for name in cluster.slices})

    cluster.run(until=5.0)
    print("\nt=5s: slice0 FAILS (node loss) — re-admitting its requests...")
    lost = cluster.fail_slice("slice0")
    print(f"  re-routed {cluster.reroutes}, shed {len(lost)} (admission-protected)")

    cluster.run(until=8.0)
    print("t=8s: slice1 degrades 3x (straggler) — future admissions rescaled")
    cluster.mark_slow("slice1", 3.0)

    cluster.run()
    agg = cluster.aggregate_metrics()
    print(
        f"\nfinal: completed={agg['completed_frames']} "
        f"missed={agg['missed_frames']} (miss rate {agg['miss_rate']:.2%}) "
        f"rerouted={agg['reroutes']} dropped={agg['dropped_requests']}"
    )
    return agg


if __name__ == "__main__":
    main()
