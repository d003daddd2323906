"""DeepRT core: the paper's contribution as a composable library.

A copy of the numpy-only ``repro.core`` modules with imports re-pointed
here and no change in behaviour, exporting the same names.
"""
from repro_torch.core.adaptation import AdaptationModule, default_shrink
from repro_torch.core.admission import (
    AdmissionControl,
    AdmissionResult,
    CategorySnapshot,
    SystemState,
    phase1_from_scheduler,
    snapshot_from_scheduler,
)
from repro_torch.core.baselines import AIMD, BATCH, BATCHDelay, SEDF
from repro_torch.core.bucketing import (
    arena_slots,
    bucket,
    bucket_sizes,
    padding_fraction,
    slice_arena_slots,
)
from repro_torch.core.cluster import (
    HEALTHY,
    QUARANTINED,
    SUSPECT,
    ClusterScheduler,
    LiveSlice,
    ParkedTail,
    Slice,
    SliceHealthMonitor,
    SliceSpec,
    build_sim_cluster,
)
from repro_torch.core.disbatcher import WINDOW_FRACTION, DisBatcher
from repro_torch.core.edf import ChunkPolicy, DeadlineQueue, EDFWorker
from repro_torch.core.faults import (
    DEATH,
    DELAY,
    DUP_COMPLETE,
    REORDER_COMPLETE,
    STALL,
    SUBMIT_ERROR,
    CompletionWatchdog,
    DeviceDeadError,
    FaultPlan,
    FaultSpec,
    FaultyDevice,
    TransientSubmitError,
    WatchdogConfig,
)
from repro_torch.core.profiler import (
    AnalyticProfiler,
    HardwareSpec,
    MeasuredProfiler,
    ProfileTable,
)
from repro_torch.core.request import (
    Category,
    ChunkJob,
    Frame,
    JobInstance,
    PseudoJob,
    Request,
)
from repro_torch.core.scheduler import DeepRT, ExecutionModel
from repro_torch.core.simulator import (
    EventLoop,
    Metrics,
    ProcessorSharingDevice,
    SequentialDevice,
    WallClock,
)
from repro_torch.core.telemetry import (
    FrameTracer,
    LatencyHistogram,
    SpanEvent,
    render_text,
)
from repro_torch.core.traces import DESKTOP_TRACES, JETSON_TRACES, TraceSpec, generate_trace

__all__ = [
    "AdaptationModule",
    "default_shrink",
    "AdmissionControl",
    "AdmissionResult",
    "CategorySnapshot",
    "SystemState",
    "phase1_from_scheduler",
    "snapshot_from_scheduler",
    "AIMD",
    "BATCH",
    "BATCHDelay",
    "SEDF",
    "arena_slots",
    "bucket",
    "bucket_sizes",
    "padding_fraction",
    "slice_arena_slots",
    "ClusterScheduler",
    "LiveSlice",
    "Slice",
    "SliceSpec",
    "SliceHealthMonitor",
    "ParkedTail",
    "build_sim_cluster",
    "HEALTHY",
    "SUSPECT",
    "QUARANTINED",
    "WINDOW_FRACTION",
    "DisBatcher",
    "DeadlineQueue",
    "EDFWorker",
    "ChunkPolicy",
    "CompletionWatchdog",
    "DeviceDeadError",
    "FaultPlan",
    "FaultSpec",
    "FaultyDevice",
    "TransientSubmitError",
    "WatchdogConfig",
    "DELAY",
    "STALL",
    "SUBMIT_ERROR",
    "DEATH",
    "DUP_COMPLETE",
    "REORDER_COMPLETE",
    "AnalyticProfiler",
    "HardwareSpec",
    "MeasuredProfiler",
    "ProfileTable",
    "Category",
    "ChunkJob",
    "Frame",
    "JobInstance",
    "PseudoJob",
    "Request",
    "DeepRT",
    "ExecutionModel",
    "EventLoop",
    "Metrics",
    "ProcessorSharingDevice",
    "SequentialDevice",
    "WallClock",
    "FrameTracer",
    "LatencyHistogram",
    "SpanEvent",
    "render_text",
    "DESKTOP_TRACES",
    "JETSON_TRACES",
    "TraceSpec",
    "generate_trace",
]
