"""Per-layer metric readers, one file per metric (``<metric>.py``).

Each gives ``LAYER``, ``UNIT``, ``MOVES`` and ``read(reading)``: the
metric from the run's counters, the port's frame spans or the device
trace, or None where the run has nothing for it to read.
"""
