"""ssd_chunk's bound time over its measured device time, summed over the traced window's prefill launches (Mamba-2 prompts)."""
from rtbench.metrics import _common

LAYER = "kernels (kernels/)"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    return _common.roofline_share(reading, "ssd_chunk")
