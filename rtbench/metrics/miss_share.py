"""DeepRT's miss rate: frames of admitted streams not answered in time
(shed, late, served shrunk or never completed), as a share of the
admitted streams' frames due in the window (the frame log, host clock)."""

LAYER = "served path (ingest gateway to completion)"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    admitted = [f for f in reading.frames if f.admitted]
    if not admitted:
        return None
    return 100.0 * sum(1 for f in admitted if not f.on_time) / len(admitted)
