"""Bridge: DeepRT scheduler <-> the inference engine, in PyTorch.

Live serving uses the identical scheduler objects as simulation, with
two swaps:
- the event loop is a WallClock;
- the device is an ``AsyncDevice``: the EDF worker's submit enqueues the
  job on the CUDA stream without blocking and the loop keeps scheduling
  (DisBatcher window joints, admission, adaptation) while the card
  executes — exactly the overlap the ``SequentialDevice`` simulation
  models. The completion lands back on the loop thread from a
  lightweight waiter that synchronizes on the step's CUDA event.

``build_live_scheduler`` also runs the offline Performance Profiler
(paper §4.1) over the engine to produce the WCET table the Admission
Control Module consumes. Profiling mirrors the engine's two regimes:
prefill categories get a power-of-two bucket curve; decode categories
get ONE flat entry measured with every arena row live (the worst case of
the single step that serves all batch sizes) via
``ProfileTable.record_flat``.

Not ported yet (ROADMAP.md): ``build_live_cluster`` and
``build_live_transport`` (cluster, ingest and transport layers), and
multi-step decode chunks (``chunk_depth > 1`` and ``ChunkJob`` raise).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    DeepRT,
    ExecutionModel,
    MeasuredProfiler,
    ProfileTable,
    WallClock,
)
from repro_torch.core.bucketing import arena_slots, bucket
from repro_torch.core.request import ChunkJob
from repro_torch.core.scheduler import NONRT_BATCH_CAP
from repro_torch.serving.async_device import AsyncDevice
from repro_torch.serving.engine import InferenceEngine


def profile_engine(
    engine: InferenceEngine,
    categories: Iterable[Tuple[str, Tuple[int, ...], str]],
    batch_sizes=(1, 2, 4, 8),
    runs: int = 5,
    quantile: float = 0.99,
    chunk_depth: int = 1,
) -> ProfileTable:
    """Offline profiler pass (paper §4.1): p99 over repeated runs.

    Prefill: per batch-bucket curve (deduped to buckets — the engine
    executes the identical step for every size in one). Decode: the
    slot arena runs one step whose cost is flat in batch size, so a
    per-batch curve would time the same step repeatedly; measure the
    worst case (all ``max_slots`` rows live) once and record it flat.

    ``chunk_depth`` must be 1: multi-step decode chunks are not ported
    yet (ROADMAP.md).
    """
    if chunk_depth > 1:
        raise NotImplementedError(
            "multi-step decode chunks are not ported yet "
            "(ROADMAP.md: decode_chunk and CUDA graphs)"
        )
    cats = list(categories)
    # ProfileTable keys (and the bridge's kind_of map) are (model, shape)
    # — one kind per key by design. Profiling a shape as BOTH kinds would
    # make the flat decode entry silently shadow the prefill curve; fail
    # loudly instead.
    seen_kinds: Dict[Tuple[str, Tuple[int, ...]], str] = {}
    for mid, shape_key, kind in cats:
        prev = seen_kinds.setdefault((mid, tuple(shape_key)), kind)
        if prev != kind:
            raise ValueError(
                f"category ({mid}, {shape_key}) profiled as both {prev!r} "
                f"and {kind!r}; WCET keys carry no kind — use distinct "
                f"shapes per kind"
            )
    table = ProfileTable()
    profiler = MeasuredProfiler(warmup=2, runs=runs, quantile=quantile)
    for mid, shape_key, kind in cats:
        if kind == "decode":
            # Measure into a throwaway table (never into ``table``, whose
            # (mid, shape) key space the flat entry will own), with
            # bucketed=False: max_slots need not be a power of two, and
            # rounding it up would probe a batch the engine rejects.
            probe = ProfileTable()
            profiler.profile(
                probe,
                mid,
                shape_key,
                [engine.max_slots],
                lambda b, _m=mid, _s=shape_key: engine.execute(_m, _s, b, "decode"),
                bucketed=False,
            )
            wcet = probe.entries[(mid, tuple(shape_key))][engine.max_slots]
            table.record_flat(mid, shape_key, wcet, engine.max_slots)
        else:
            profiler.profile(
                table,
                mid,
                shape_key,
                list(batch_sizes),
                lambda b, _m=mid, _s=shape_key, _k=kind: engine.execute(_m, _s, b, _k),
            )
    return table


def _wire_live_scheduler(
    engine: InferenceEngine,
    table: ProfileTable,
    loop: WallClock,
    kinds: Dict[Tuple[str, Tuple[int, ...]], str],
    utilization_bound: float = 1.0,
) -> Tuple[DeepRT, AsyncDevice]:
    """Wire one live DeepRT over one engine behind the device contract.

    Decode jobs run the arena's first-``batch_size``-rows prefix; the
    slot-aware mode (arena-row leases per stream, ``device_wrap`` for
    fault injection) arrives with ``build_live_cluster`` (ROADMAP.md).
    """

    def kind_of(job) -> str:
        # Keyed by the CATEGORY's shape: step kind is a property of the
        # category, and an adaptation-shrunk job must keep its kind even
        # if its running shape coincides with another category's.
        return kinds.get(
            (job.category.model_id, job.category.shape_key), "prefill"
        )

    def job_payload(job):
        """Per-frame ingested payloads, in the engine's payload form.
        All-``None`` (simulation traces, profiler warm-up) collapses to
        ``None`` — a zero frame through the same staging ring."""
        if all(f.payload is None for f in job.frames):
            return None
        return [f.payload for f in job.frames]

    def job_bytes(job) -> float:
        return engine.job_bytes(
            job.category.model_id, job.shape_key, job.batch_size, kind_of(job)
        )

    def executed_rows(job) -> int:
        # Arena decode always runs max_slots rows; prefill pads to the
        # power-of-two bucket. Keeps Metrics.padding_waste describing
        # what the engine really launched.
        if kind_of(job) == "decode":
            return engine.max_slots
        return bucket(job.batch_size)

    def dispatch_job(job):
        mid, shape = job.category.model_id, job.shape_key
        kind = kind_of(job)
        if isinstance(job, ChunkJob):
            raise NotImplementedError(
                f"chunked decode dispatch for {mid}/{shape} is not ported "
                f"yet (ROADMAP.md: decode_chunk and CUDA graphs)"
            )
        payload = job_payload(job)
        if kind == "decode" and payload is not None:
            # Prefix-mode decode assigns rows POSITIONALLY per window and
            # never advances the resident cursors — real tokens would land
            # in different rows step to step, reading other streams' KV.
            # Payload-carrying decode needs arena-row leases (the cluster
            # path); fail loudly rather than serve corrupted streams.
            raise RuntimeError(
                f"decode job for {mid}/{shape} carries real payload but no "
                f"arena leases: decode streams with payloads need the "
                f"slot-aware cluster path, not the prefix path"
            )
        return engine.dispatch(mid, shape, job.batch_size, kind, payload=payload)

    device = AsyncDevice(loop, dispatch_fn=dispatch_job)
    # exec_time under async dispatch is the busy-until ESTIMATE (the
    # profiled WCET); the device reports the real completion instant.
    sched = DeepRT(
        table,
        loop=loop,
        execution=ExecutionModel(actual_fn=lambda job, wcet: wcet),
        utilization_bound=utilization_bound,
        device=device,
    )
    sched.worker.job_bytes_fn = job_bytes
    sched.worker.executed_rows_fn = executed_rows
    # Non-RT requests bypass admission (the flat table's inf cannot
    # reject them), so bound their batches by the arena too — including
    # for caller-supplied engines whose max_slots may be small.
    sched.nonrt_batch_cap = min(sched.nonrt_batch_cap, engine.max_slots)
    return sched, device


def build_live_scheduler(
    configs: Dict[str, ModelConfig],
    categories: Iterable[Tuple[str, Tuple[int, ...], str]],
    batch_sizes=(1, 2, 4, 8),
    utilization_bound: float = 1.0,
    engine: Optional[InferenceEngine] = None,
    chunk_depth: int = 1,
    tracer=None,
    device="cuda",
    profile_runs: int = 5,
) -> Tuple[DeepRT, InferenceEngine, ProfileTable]:
    """Build the live wall-clock DeepRT over an engine.

    Zero-stall pipeline: profiled WCET estimates drive ``busy_until``,
    the AsyncDevice measures reality. The engine's decode arena is sized
    to the largest requested batch (``arena_slots``), so every admitted
    job fits the one resident step.

    ``device`` places the engine this function builds (``"cuda"`` by
    default; a caller-supplied ``engine`` keeps its own).
    ``profile_runs``: offline-profiler repetitions per batch size.
    ``chunk_depth`` must be 1 (multi-step decode chunks are not ported).
    """
    if engine is None:
        # Non-RT requests bypass admission (their batches are bounded by
        # NONRT_BATCH_CAP, not by the imitator), so the arena must hold
        # that cap too — RT oversubscription is rejected at admission via
        # the flat table's inf beyond max_slots.
        engine = InferenceEngine(
            configs,
            max_slots=arena_slots(max(*batch_sizes, NONRT_BATCH_CAP)),
            chunk_depth=chunk_depth,
            device=device,
        )
    cats = list(categories)
    kinds = {(mid, tuple(shape)): kind for mid, shape, kind in cats}
    table = profile_engine(
        engine, cats, batch_sizes, runs=profile_runs, chunk_depth=chunk_depth
    )
    engine.reset_stats()  # stats cover served traffic, not profiling
    sched, _device = _wire_live_scheduler(
        engine, table, WallClock(), kinds, utilization_bound
    )
    if tracer is not None:
        sched.attach_tracer(tracer)
    return sched, engine, table


