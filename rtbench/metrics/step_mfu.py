"""Model operations of the traced window's steps (real rows only) over their summed device spans at the bf16 peak."""
from rtbench.costs import peaks
from rtbench.metrics import _common

LAYER = "engine step (serving/engine.py)"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    flops = span = 0.0
    for rec, jd in _common.traced_jobs(reading):
        flops += _common.step_flops(reading, rec)
        span += jd.span_ns / 1e9
    if span <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (span * peaks.BF16_FLOPS)
