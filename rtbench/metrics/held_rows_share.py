"""Leased arena rows a decode step held (no frame of their stream in the job: attention, cursor and recurrent state left as they were) over the rows it stepped or held, in the window's slot-mode decode dispatches.

The program's counts ride on the EDF worker's ``device_submit`` span
(``rows_stepped``, ``rows_held``; ``Metrics.decode_rows_stepped`` and
``decode_rows_held`` sum the same), read from the frame tracer of a
traced run. None where the program records no such counts or the
window dispatched no slot-mode decode step.
"""

LAYER = "engine step (serving/engine.py)"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    tracer = reading.tracer
    if tracer is None:
        return None
    w0, w1 = reading.window
    stepped = held = 0
    for ev in tracer.ring:
        meta = ev.meta
        if (ev.stage == "device_submit" and meta and "rows_held" in meta
                and w0 <= ev.t < w1):
            stepped += meta["rows_stepped"]
            held += meta["rows_held"]
    if stepped + held <= 0:
        return None
    return 100.0 * held / (stepped + held)
