"""Traffic: frozen copies of the port's frame sources and synthetic
traces, and the one generator (``plan``) that turns a mix file into
streams."""
