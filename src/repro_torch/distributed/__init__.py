"""Sharding: the logical-axis rules engine over DTensor meshes (the port of
``repro.distributed``)."""
