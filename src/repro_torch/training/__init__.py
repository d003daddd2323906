"""Training: AdamW, seekable synthetic data, int8 gradient compression and
the train step (the port of ``repro.training``)."""
