"""Streams admitted, as a share of the streams offered, from the registration verdicts."""

LAYER = "admission (core/admission.py)"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    if reading.offered <= 0:
        return None
    return 100.0 * reading.admitted / reading.offered
