"""Mean time from a completed frame's window close to its job's dispatch, from the port's frame spans."""
from rtbench.metrics import _common

LAYER = "EDF worker and device contract (core/edf.py, serving/async_device.py)"
UNIT = "ms"
MOVES = "p95_latency_ms"


def read(reading):
    stages = _common.frame_stages(reading)
    if not stages:
        return None
    return 1e3 * sum(s["queue"] for s in stages) / len(stages)
