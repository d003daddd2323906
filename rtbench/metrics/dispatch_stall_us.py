"""Mean host time the loop spends picking and submitting a job (Metrics.mean_dispatch_overhead over the window)."""

LAYER = "EDF worker and device contract (core/edf.py, serving/async_device.py)"
UNIT = "us"
MOVES = "p95_latency_ms"


def read(reading):
    c = reading.counters
    if c["dispatch_count"] <= 0:
        return None
    return 1e6 * c["dispatch_overhead_sum"] / c["dispatch_count"]
