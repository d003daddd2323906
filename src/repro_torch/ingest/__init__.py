"""Streaming ingestion gateway: real frame/token ingestion in front of
the DeepRT serving stack (sources -> sessions -> staging rings). The
datagram transport in front of the sessions is not ported yet
(ROADMAP.md)."""
from repro_torch.ingest.session import IngestGateway, ShedPolicy, StreamSession
from repro_torch.ingest.sources import (
    BurstSource,
    CameraSource,
    FramePlan,
    FrameSource,
    PeriodicSource,
    TraceSource,
)
from repro_torch.ingest.staging import StagingRing, check_payload_dtype

__all__ = [
    "IngestGateway",
    "ShedPolicy",
    "StreamSession",
    "BurstSource",
    "CameraSource",
    "FramePlan",
    "FrameSource",
    "PeriodicSource",
    "TraceSource",
    "StagingRing",
    "check_payload_dtype",
]
