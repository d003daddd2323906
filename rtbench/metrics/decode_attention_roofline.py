"""decode_attention's bound time over its measured device time, summed over the traced window's launches."""
from rtbench.metrics import _common

LAYER = "kernels (kernels/)"
UNIT = "%"
MOVES = "p95_latency_ms"


def read(reading):
    return _common.roofline_share(reading, "decode_attention")
