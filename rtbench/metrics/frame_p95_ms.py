"""The 95th percentile latency, due time to completion, of the attempted
frames that completed (nearest rank, host clock). Beside
``goodput_tok_s``: a cell whose frames are shed or served shrunk above a
few percent has no finite tail over all frames, so the tail of the
completed ones is read here."""
from rtbench.framelog import nearest_rank

LAYER = "served path (ingest gateway to completion)"
UNIT = "ms"
MOVES = "goodput_tok_s"


def read(reading):
    done = [f.latency for f in reading.frames
            if f.admitted and f.completion is not None]
    if not done:
        return None
    return 1e3 * nearest_rank(done, 0.95)
