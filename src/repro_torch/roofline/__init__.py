"""Roofline: FLOP, byte and collective counts of a call, the three terms
against the H100's rates, and the dry run's table (the port of
``repro.roofline``)."""
