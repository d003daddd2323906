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
``ProfileTable.record_flat``. With ``chunk_depth > 1`` each decode
category also gets its k-step chunk family, which is the warm-up that
captures every decode step's CUDA graph (a chunk replays the step's),
and DeepRT wires the EDF worker's slack-driven ``ChunkPolicy`` off it.

``build_live_cluster`` generalizes this to a pod: N slices on ONE
WallClock, each with its own engine (per-slice arena sized by
``bucketing.slice_arena_slots`` under that slice's Phase-1 utilization
bound), its own AsyncDevice, and its own profiled table, registered
into a ``ClusterScheduler`` that does placement, spill, per-request
arena-row leases, and failover re-admission (``core/cluster.py``). On
one card the slices' engines launch on the same CUDA stream, so a slice's
profiled WCETs stay what they measured alone.

``build_live_transport`` puts the ingest gateway and the datagram
transport (``ingest/transport.py``) in front of such a cluster: the
transport server is the cluster's rehome owner, so a failed slice's
sessions continue on a survivor with their buffered bytes.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    DeepRT,
    ExecutionModel,
    MeasuredProfiler,
    ProfileTable,
    WallClock,
)
from repro_torch.core.bucketing import (
    arena_slots,
    bucket,
    chunk_depths,
    slice_arena_slots,
)
from repro_torch.core.cluster import ClusterScheduler, LiveSlice, SliceSpec
from repro_torch.core.faults import (
    CompletionWatchdog,
    FaultPlan,
    FaultyDevice,
    WatchdogConfig,
)
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

    ``chunk_depth`` > 1 additionally profiles each decode category's
    k-step chunks over the power-of-two depth ladder
    (``bucketing.chunk_depths``), recording the per-depth flat WCET
    family (``record_flat(..., k=k)``) that the EDF worker's slack rule
    consumes. Measuring here is also the WARM-UP: every decode step and
    every prefill bucket the worker can later choose is captured as a
    CUDA graph during profiling (a chunk is k replays of its step's
    graph), so serving stays at zero captures of either kind. Raw per-depth
    measurements are clamped monotone non-decreasing in k before
    recording (timer jitter on near-equal depths must not read as a
    family inversion).
    """
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
            if chunk_depth > 1:
                prev = 0.0
                for k in chunk_depths(min(chunk_depth, engine.max_chunk_depth)):
                    probe_k = ProfileTable()
                    profiler.profile(
                        probe_k,
                        mid,
                        shape_key,
                        [engine.max_slots],
                        lambda b, _m=mid, _s=shape_key, _k=k: (
                            engine.execute_chunk(_m, _s, b, _k)
                        ),
                        bucketed=False,
                    )
                    w = max(probe_k.entries[(mid, tuple(shape_key))][engine.max_slots], prev)
                    table.record_flat(mid, shape_key, w, engine.max_slots, k=k)
                    prev = w
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
    slot_aware: bool = False,
    leases: Optional[Dict[int, Tuple[str, int, Tuple[int, ...]]]] = None,
    device_wrap: Optional[Callable[[AsyncDevice], Any]] = None,
) -> Tuple[DeepRT, Any]:
    """Wire one live DeepRT over one engine behind the device contract.

    Shared by the single-device ``build_live_scheduler`` and the
    per-slice loop of ``build_live_cluster``. ``slot_aware=True`` makes
    decode jobs step the arena's allocator-live rows (the cluster leases
    one row per admitted decode stream) instead of the synthetic
    first-``batch_size``-rows prefix; either way the SAME step executes
    (one CUDA-graph replay per step on the card) — batch size is data.

    ``device_wrap`` interposes on the device AFTER construction but
    BEFORE the scheduler binds to it (fault injection wraps here: the
    scheduler then submits through the wrapper, while the wrapper
    injects at the real AsyncDevice's dispatch-handle layer).

    ``leases`` (slot-aware mode) is the request_id -> (mid, seq, rows)
    map the ``LiveSlice`` maintains — shared BY REFERENCE so decode
    dispatch can slot-align each frame's ingested token: stream X's
    payload lands in stream X's resident arena row, never a neighbor's.
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

    # Filled in once the scheduler exists (the device needs dispatch_job
    # at construction, before the DeepRT that owns the metrics).
    metrics_ref: Dict[str, Any] = {}

    def slot_payload(job, mid: str, seq: int):
        """{arena row -> token} for a slot-mode decode step: each
        frame's token goes to its own stream's leased row. One step
        consumes ONE token per row, so when a window batched two frames
        of the same stream the EARLIEST frame's token is staged (tokens
        stay in order) and the collision is counted in
        ``Metrics.payload_collisions`` — visible degradation, not a
        silent overwrite."""
        if leases is None or all(f.payload is None for f in job.frames):
            return None
        out: Dict[int, int] = {}
        for f in job.frames:
            lease = leases.get(f.request_id)
            if lease is None or lease[0] != mid or lease[1] != seq:
                continue  # no resident row (e.g. re-admitted mid-window)
            row = lease[2][0]
            tok = 0 if f.payload is None else int(np.asarray(f.payload))
            if row in out:
                metrics = metrics_ref.get("metrics")
                if metrics is not None:
                    metrics.payload_collisions += 1
                continue  # earliest frame's token wins (in-order)
            out[row] = tok
        return out or None

    def job_bytes(job) -> float:
        steps = job.k if isinstance(job, ChunkJob) else 1
        return engine.job_bytes(
            job.category.model_id, job.shape_key, job.batch_size,
            kind_of(job), steps=steps,
        )

    def executed_rows(job) -> int:
        # Arena decode always runs max_slots rows; prefill pads to the
        # power-of-two bucket. Keeps Metrics.padding_waste describing
        # what the engine really launched.
        if kind_of(job) == "decode":
            return engine.max_slots
        return bucket(job.batch_size)

    def frame_rows(job, mid: str, seq: int):
        """Arena rows whose stream has a frame in THIS job: only they
        run active (consume their token, advance their cursor) — a
        leased stream with no frame this window must not eat a phantom
        zero token. None (no lease info) = step everything active.
        An EMPTY list is returned as-is, never collapsed to None: a job
        whose every frame lost its lease (stream closed with a frame
        still queued in the window) must step NOTHING active, or the
        surviving streams' rows would each consume a phantom zero."""
        if leases is None:
            return None
        rows = []
        for f in job.frames:
            lease = leases.get(f.request_id)
            if lease is not None and lease[0] == mid and lease[1] == seq:
                rows.append(lease[2][0])
        return rows

    def count_rows(job, live, step_rows) -> None:
        """Count a slot-mode decode dispatch's stepped and held rows in
        ``Metrics`` and on the job (the EDF worker's ``device_submit``
        span carries them)."""
        stepped = sum(len(live) if r is None else len(set(r)) for r in step_rows)
        held = len(live) * len(step_rows) - stepped
        job.decode_rows = (stepped, held)
        metrics = metrics_ref.get("metrics")
        if metrics is not None:
            metrics.decode_rows_stepped += stepped
            metrics.decode_rows_held += held

    def dispatch_job(job):
        mid, shape = job.category.model_id, job.shape_key
        kind = kind_of(job)
        if isinstance(job, ChunkJob):
            # A fused k-step decode chunk: ONE dispatch of depth job.k,
            # with each member job's payload staged as its own step (one
            # staging-ring slot per step) and each step's frame-bearing
            # rows masked per member — the idle-row semantics of
            # single-step ``step_rows``, held per step.
            if kind != "decode":
                raise RuntimeError(
                    f"chunked dispatch for non-decode category {mid}/{shape}"
                )
            seq = shape[0]
            if slot_aware:
                live = engine.arena(mid, seq).live
                if live:
                    rows = [frame_rows(j, mid, seq) for j in job.jobs]
                    handle = engine.decode_chunk(
                        mid, shape, len(live), job.k, slots=live,
                        payloads=[
                            slot_payload(j, mid, seq) for j in job.jobs
                        ],
                        step_rows=rows,
                    )
                    count_rows(job, live, rows)
                    return handle
            for j in job.jobs:
                if job_payload(j) is not None and leases is None:
                    raise RuntimeError(
                        f"decode chunk for {mid}/{shape} carries real "
                        f"payload but no arena leases: ingest decode "
                        f"streams through build_live_cluster "
                        f"(slot-aware), not the prefix path"
                    )
            # No leased rows left (streams closed with frames queued):
            # drain the chunk as a zero-payload prefix dispatch.
            b = min(max(j.batch_size for j in job.jobs), engine.max_slots)
            return engine.decode_chunk(mid, shape, b, job.k)
        if slot_aware and kind == "decode":
            live = engine.arena(mid, shape[0]).live
            if live:
                # Continuous batching: every step runs ALL leased rows
                # through the one step (a subset would clobber the
                # skipped rows' caches), but only the rows whose stream
                # has a frame this window are ACTIVE.
                rows = frame_rows(job, mid, shape[0])
                handle = engine.dispatch(
                    mid, shape, len(live), kind, slots=live,
                    payload=slot_payload(job, mid, shape[0]),
                    step_rows=rows,
                )
                count_rows(job, live, [rows])
                return handle
        payload = job_payload(job)
        if kind == "decode" and payload is not None:
            if leases is None:
                # Prefix-mode decode assigns rows POSITIONALLY per
                # window and never advances the resident cursors — real
                # tokens would land in different rows step to step,
                # reading other streams' KV. Payload-carrying decode
                # requires the slot-aware cluster path (arena-row
                # leases); fail loudly rather than serve silently
                # corrupted streams. (The gateway also refuses decode
                # registration on a single-device target.)
                raise RuntimeError(
                    f"decode job for {mid}/{shape} carries real payload "
                    f"but no arena leases: ingest decode streams through "
                    f"build_live_cluster (slot-aware), not the prefix path"
                )
            # Cluster path with NO leased row left on this arena: every
            # frame's stream already released its lease (closed with
            # frames still queued). Nothing resident to step — drain the
            # job as a zero-payload no-op (tokens discarded; the frames
            # complete, the streams are gone).
            payload = None
        return engine.dispatch(mid, shape, job.batch_size, kind, payload=payload)

    device = AsyncDevice(loop, dispatch_fn=dispatch_job, mark_fn=engine.stream_mark)
    if device_wrap is not None:
        device = device_wrap(device)
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
    metrics_ref["metrics"] = sched.metrics
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
    ``chunk_depth`` > 1 enables multi-step decode chunking: the engine
    is built to serve chunks that deep, every depth on the ladder is
    profiled into the table's chunk family, and DeepRT auto-wires the
    EDF worker's slack-driven depth policy off that family.
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


def build_live_cluster(
    configs: Dict[str, ModelConfig],
    categories: Iterable[Tuple[str, Tuple[int, ...], str]],
    slice_names: Sequence[str] = ("slice0", "slice1"),
    batch_sizes=(1, 2, 4, 8),
    utilization_bounds: Optional[Dict[str, float]] = None,
    profile_runs: int = 5,
    nonrt_cap: int = NONRT_BATCH_CAP,
    watchdog: Optional[WatchdogConfig] = None,
    fault_plans: Optional[Dict[str, FaultPlan]] = None,
    chunk_depth: int = 1,
    tracer=None,
    device="cuda",
    params: Optional[Dict[str, Any]] = None,
) -> Tuple[ClusterScheduler, Dict[str, LiveSlice]]:
    """Build a live multi-slice cluster: ``build_live_scheduler``, sliced.

    One shared WallClock; per slice, its OWN InferenceEngine (resident
    KV arena sized by ``bucketing.slice_arena_slots`` under that slice's
    Phase-1 utilization bound, its own decode graphs and graph pool), its
    own AsyncDevice, and its own profiled WCET table — the arena is
    device-resident state, so slicing the fleet slices the arenas.
    Placement, spill-on-reject, per-request arena-row leases, and
    ``fail_slice`` re-admission all run through the returned
    ``ClusterScheduler``.

    ``utilization_bounds``: per-slice-name Phase-1 ceiling (default 1.0).
    Slices that share one card should get bounds summing to at most
    1.0: each slice's WCETs were profiled with the card to itself.
    ``profile_runs``: offline-profiler repetitions per slice (each slice
    profiles, and captures, its own decode steps).
    ``nonrt_cap``: lets callers that serve no non-RT traffic shrink the
    arena floor below ``NONRT_BATCH_CAP`` (tests, benchmarks).
    ``watchdog``: arms the fault-tolerance loop — each slice's device
    gets a ``CompletionWatchdog`` (per-submit deadline = WCET × slack,
    floored by ``min_deadline``) and measured-completion reporting wired
    to the cluster's ``SliceHealthMonitor``, which drives the
    healthy/suspect/quarantined state machine, auto-``fail_slice`` on
    hangs, and live WCET re-profiling. Profiling itself bypasses the
    device, so watchdog deadlines only ever cover served jobs.
    ``fault_plans``: per-slice-name deterministic fault injection
    (``FaultyDevice`` wraps that slice's AsyncDevice at the
    dispatch-handle layer — chaos tests and benchmarks only).
    ``chunk_depth``: > 1 enables slack-driven multi-step decode
    chunking on every slice (engines built chunk-capable, per-depth
    WCET families profiled, EDF workers auto-wired — see
    ``build_live_scheduler``).
    ``device``: where every slice's engine lives (``"cuda"`` by default).
    ``params``: model id -> parameter tree, given to every slice's
    engine; other models are drawn from each engine's seeded generator,
    the same draw on every slice, so a tail that fails over continues on
    the same weights.
    """
    cats = list(categories)
    kinds = {(mid, tuple(shape)): kind for mid, shape, kind in cats}
    bounds = dict(utilization_bounds or {})
    unknown = set(bounds) - set(slice_names)
    if unknown:
        # A typoed bound would otherwise silently default that slice to
        # 1.0 — full-size arena, unbounded admission.
        raise ValueError(
            f"utilization_bounds for unknown slices {sorted(unknown)}; "
            f"slice_names = {list(slice_names)}"
        )
    plans = dict(fault_plans or {})
    unknown_plans = set(plans) - set(slice_names)
    if unknown_plans:
        raise ValueError(
            f"fault_plans for unknown slices {sorted(unknown_plans)}; "
            f"slice_names = {list(slice_names)}"
        )
    loop = WallClock()
    cluster = ClusterScheduler(loop=loop, watchdog=watchdog)
    slices: Dict[str, LiveSlice] = {}
    max_batch = max(*batch_sizes, nonrt_cap)
    for name in slice_names:
        bound = bounds.get(name, 1.0)
        engine = InferenceEngine(
            configs, max_slots=slice_arena_slots(max_batch, bound),
            chunk_depth=chunk_depth, device=device, params=params,
        )
        table = profile_engine(
            engine, cats, batch_sizes, runs=profile_runs,
            chunk_depth=chunk_depth,
        )
        engine.reset_stats()  # stats cover served traffic, not profiling
        # One lease map per slice, shared by reference between the
        # dispatch closure (slot-aligned payload staging) and the
        # LiveSlice (lease lifecycle).
        leases: Dict[int, Tuple[str, int, Tuple[int, ...]]] = {}
        wrap = None
        if name in plans:
            wrap = partial(_wrap_faulty, plan=plans[name])
        sched, dev = _wire_live_scheduler(
            engine, table, loop, kinds,
            utilization_bound=bound, slot_aware=True, leases=leases,
            device_wrap=wrap,
        )
        inner = dev.inner if isinstance(dev, FaultyDevice) else dev
        if watchdog is not None:
            # The watchdog lives on the REAL AsyncDevice: injected faults
            # then look exactly like hardware misbehavior to it.
            inner.watchdog = CompletionWatchdog(
                loop, watchdog,
                on_overdue=partial(cluster.health.note_overdue, name),
            )
            inner.on_measured = partial(cluster.health.note_complete, name)
        if isinstance(dev, FaultyDevice):
            dev.on_submit_error = partial(
                cluster.health.note_submit_error, name
            )
        spec = SliceSpec(name=name, table=table, utilization_bound=bound)
        sl = LiveSlice(
            spec, scheduler=sched, engine=engine, kinds=kinds, leases=leases
        )
        cluster.register(sl)
        slices[name] = sl
        # Execution-substrate observability: telemetry_snapshot folds in
        # each engine's arena occupancy / staging-ring reuse via probes.
        cluster.telemetry_probes[f"engine_{name}"] = engine.telemetry
    if tracer is not None:
        cluster.attach_tracer(tracer)
    return cluster, slices


def _wrap_faulty(device: AsyncDevice, plan: FaultPlan) -> FaultyDevice:
    return FaultyDevice(device, plan)


def build_live_transport(
    configs: Dict[str, ModelConfig],
    categories: Iterable[Tuple[str, Tuple[int, ...], str]],
    slice_names: Sequence[str] = ("slice0", "slice1"),
    batch_sizes=(1, 2, 4, 8),
    utilization_bounds: Optional[Dict[str, float]] = None,
    profile_runs: int = 5,
    nonrt_cap: int = NONRT_BATCH_CAP,
    watchdog: Optional[WatchdogConfig] = None,
    fault_plans: Optional[Dict[str, FaultPlan]] = None,
    chunk_depth: int = 1,
    tracer=None,
    shedding: bool = True,
    udp: bool = False,
    host: str = "127.0.0.1",
    port: int = 0,
    device="cuda",
    params: Optional[Dict[str, Any]] = None,
    **transport_kwargs,
):
    """``build_live_cluster`` with the network front door attached.

    Stacks the ingest gateway and the transport server over a live
    cluster — the full networked serving path on one WallClock: wire
    datagrams -> reassembly (reorder window, dedup, late rejection) ->
    gateway shedding/backpressure -> placement/admission/leases -> EDF.
    The transport server registers as the cluster's rehome owner, so a
    ``fail_slice`` re-homes live sessions with their buffered bytes.

    ``udp=True`` additionally binds a real UDP socket front end on
    ``host``:``port`` (started; callers own ``binding.close()``).
    ``device`` and ``params`` go to ``build_live_cluster``.
    ``transport_kwargs`` forward to
    :class:`~repro_torch.ingest.transport.TransportServer` (flow_control,
    reorder_window, record_payloads, ...).

    Returns ``(cluster, slices, gateway, transport, binding)`` with
    ``binding=None`` unless ``udp``.
    """
    # Imported here: serving must stay importable without dragging the
    # ingest package into every bridge user (and vice versa).
    from repro_torch.ingest.session import IngestGateway
    from repro_torch.ingest.transport import TransportServer, UdpServerBinding

    cluster, slices = build_live_cluster(
        configs, categories,
        slice_names=slice_names,
        batch_sizes=batch_sizes,
        utilization_bounds=utilization_bounds,
        profile_runs=profile_runs,
        nonrt_cap=nonrt_cap,
        watchdog=watchdog,
        fault_plans=fault_plans,
        chunk_depth=chunk_depth,
        tracer=tracer,
        device=device,
        params=params,
    )
    gateway = IngestGateway(cluster, shedding=shedding)
    transport = TransportServer(gateway, **transport_kwargs)
    if tracer is not None:
        gateway.tracer = tracer
        transport.tracer = tracer
    binding = None
    if udp:
        binding = UdpServerBinding(transport, host=host, port=port).start()
    return cluster, slices, gateway, transport, binding
