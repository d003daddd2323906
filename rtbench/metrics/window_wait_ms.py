"""Mean time from a completed frame's ingest to the close of its DisBatcher window, from the port's frame spans."""
from rtbench.metrics import _common

LAYER = "DisBatcher (core/disbatcher.py)"
UNIT = "ms"
MOVES = "p95_latency_ms"


def read(reading):
    stages = _common.frame_stages(reading)
    if not stages:
        return None
    return 1e3 * sum(s["window"] for s in stages) / len(stages)
