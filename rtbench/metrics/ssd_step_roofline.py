"""ssd_step's bound time (each stepped row's float32 state read and written once) over its measured device time, summed over the traced window's decode steps."""
from rtbench.metrics import _common

LAYER = "kernels (kernels/)"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    return _common.roofline_share(reading, "ssd_step")
