"""Streaming ingestion gateway: real frame/token ingestion in front of
the DeepRT serving stack (sources -> sessions -> transport -> staging
rings)."""
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
from repro_torch.ingest.transport import (
    DROP,
    DUPLICATE,
    HELLO_RETRY,
    LINK_DELAY,
    LINK_FAULT_KINDS,
    MALFORMED,
    REORDER,
    LinkFault,
    LinkPlan,
    SimLink,
    TransportServer,
    TransportSession,
    TransportSource,
    UdpClientLink,
    UdpServerBinding,
)

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
    "LinkFault",
    "LinkPlan",
    "SimLink",
    "TransportServer",
    "TransportSession",
    "TransportSource",
    "UdpClientLink",
    "UdpServerBinding",
    "DROP",
    "DUPLICATE",
    "HELLO_RETRY",
    "MALFORMED",
    "REORDER",
    "LINK_DELAY",
    "LINK_FAULT_KINDS",
]
