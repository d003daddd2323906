"""Device busy time per dispatched prefill step, from the traced window's device trace."""
from rtbench.metrics import _common

LAYER = "engine step (serving/engine.py)"
UNIT = "ms"
MOVES = "goodput_tok_s"


def read(reading):
    busy = [jd.busy_ns for _, jd in _common.traced_jobs(reading, "prefill")]
    if not busy:
        return None
    return sum(busy) / len(busy) / 1e6
