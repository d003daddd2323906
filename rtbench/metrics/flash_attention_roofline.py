"""flash_attention's bound time over its measured device time, summed over the traced window's launches."""
from rtbench.metrics import _common

LAYER = "kernels (kernels/)"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    return _common.roofline_share(reading, "flash_attention")
