"""Share of the traced window in which no operation ran on the device: 1 - the union of its activities over the window."""

LAYER = "device"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    t = reading.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
