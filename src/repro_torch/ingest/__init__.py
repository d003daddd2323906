"""Ingest: the host->device staging ring. The gateway, session and
transport layers are not ported yet (ROADMAP.md)."""
from repro_torch.ingest.staging import StagingRing, check_payload_dtype

__all__ = ["StagingRing", "check_payload_dtype"]
