"""Frames the gateway shed, as a share of the frames it ingested (the slice's Metrics counters over the window)."""

LAYER = "ingest gateway (ingest/session.py)"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    c = reading.counters
    ingested = c["dropped_frames"] + c["delivered_frames"]
    if ingested <= 0:
        return None
    return 100.0 * c["dropped_frames"] / ingested
