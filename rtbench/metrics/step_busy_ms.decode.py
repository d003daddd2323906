"""Device busy time per dispatched decode step, from the traced window's device trace."""
from rtbench.metrics import _common

LAYER = "engine step (serving/engine.py)"
UNIT = "ms"
MOVES = "p95_latency_ms"


def read(reading):
    busy = [jd.busy_ns for _, jd in _common.traced_jobs(reading, "decode")]
    if not busy:
        return None
    return sum(busy) / len(busy) / 1e6
