"""Tools run by hand on the chip when a cell is defined: the sweep that
finds admission's knee and the control readings that set the limits.
The benchmark's own runs call neither."""
