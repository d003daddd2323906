"""Real rows (frames) per dispatched job, the slice's Metrics.mean_batch over the window."""

LAYER = "DisBatcher (core/disbatcher.py)"
UNIT = "rows/job"
MOVES = "goodput_tok_s"


def read(reading):
    c = reading.counters
    if c["job_count"] <= 0:
        return None
    return c["real_rows"] / c["job_count"]
