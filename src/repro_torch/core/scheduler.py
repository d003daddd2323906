"""DeepRT: the assembled scheduler (paper Fig. 1).

Wiring:

  clients --requests--> AdmissionControl --admitted--> DisBatcher
  DisBatcher --job instances--> EDFWorker(deadline queue) --> device
  EDFWorker --overruns--> AdaptationModule --shape override--> DisBatcher

The same object drives a virtual clock (simulation: benchmarks, admission
accuracy studies) or a wall clock with a real execution backend (live
serving over jit-compiled JAX steps — see ``serving/batcher_bridge.py``).

Non-real-time requests (paper §3.3): bypass the admission test, use the
large DisBatcher window (low deadline priority under EDF), carry an
imposed minimum period, and have a batch-size cap so a non-RT job cannot
block RT jobs for long (non-preemptive blocking is bounded by one job).
The Phase-2 imitator start time already covers in-flight blocking because
the device's busy-until is part of the recorded system state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core import telemetry as T
from repro_torch.core.adaptation import AdaptationModule, default_shrink
from repro_torch.core.admission import (
    AdmissionControl,
    AdmissionResult,
    phase1_from_scheduler,
    snapshot_from_scheduler,
)
from repro_torch.core.disbatcher import DisBatcher
from repro_torch.core.edf import ChunkPolicy, EDFWorker
from repro_torch.core.profiler import ProfileTable
from repro_torch.core.request import Category, ChunkJob, Frame, JobInstance, Request
from repro_torch.core.simulator import EventLoop, Metrics, SequentialDevice

NONRT_MIN_PERIOD = 1.0  # imposed arrival period for non-RT requests (§3.3)
NONRT_BATCH_CAP = 8  # bounds priority inversion from one non-RT job


@dataclass
class ExecutionModel:
    """How "actual" execution time is produced.

    simulation: ``actual_fn(job, profiled_wcet) -> seconds``. Defaults to
    a deterministic 0.97x of profiled WCET (profiles are p99, reality sits
    just below). Benchmarks override this with samplers / overrun
    injectors. Live serving passes the identity (the profiled WCET): the
    value only seeds the AsyncDevice's ``busy_until`` estimate — the real
    completion instant comes from the hardware, never from this model.
    (The legacy blocking mode that ran the compiled step inside
    ``actual_fn`` is deleted; there is no synchronous execution path.)
    """

    actual_fn: Callable[[JobInstance, float], float] = (
        lambda job, wcet: 0.97 * wcet
    )


class DeepRT:
    def __init__(
        self,
        table: ProfileTable,
        loop: Optional[EventLoop] = None,
        execution: Optional[ExecutionModel] = None,
        adaptation_enabled: bool = True,
        shrink_fn=default_shrink,
        utilization_bound: float = 1.0,
        early_flush: bool = True,
        device=None,
    ):
        """``early_flush`` enables the paper's idle-device optimization
        (§4.3). It is guarded (see DisBatcher.flush_early) so Theorem 1's
        guarantee holds empirically (0 misses across 30k random workloads
        / 2.6M frames), but it can perturb the EDF order relative to the
        Phase-2 imitator's timeline by up to one job's non-preemptive
        blocking, so per-frame latency *predictions* are only strictly
        conservative with ``early_flush=False`` (strict mode).

        ``device`` swaps the execution backend behind the shared device
        contract (see ``simulator.SequentialDevice``): ``None`` builds a
        simulated ``SequentialDevice``; live serving passes an
        ``AsyncDevice`` so the loop never blocks on XLA."""
        self.loop = loop if loop is not None else EventLoop()
        self.table = table
        self.execution = execution if execution is not None else ExecutionModel()
        self.utilization_bound = utilization_bound
        self.early_flush = early_flush
        # Non-RT jobs bypass admission, so their batch is bounded here
        # rather than by the imitator; an execution backend with a hard
        # batch ceiling (the decode slot arena) lowers this to its
        # capacity (see serving/batcher_bridge.build_live_scheduler).
        self.nonrt_batch_cap = NONRT_BATCH_CAP
        self.metrics = Metrics()

        if device is None:
            device = SequentialDevice(self.loop, on_idle=self._on_device_idle)
        else:
            device.on_idle = self._on_device_idle
        self.device = device
        self.worker = EDFWorker(
            loop=self.loop,
            device=self.device,
            exec_time_fn=self._exec_time,
            profiled_fn=self._profiled,
            metrics=self.metrics,
            request_idle_work=self._idle_flush,
            next_rt_release_fn=lambda: self.disbatcher.earliest_next_joint(
                realtime_only=True
            ),
        )
        self.disbatcher = DisBatcher(self.loop, emit=self.worker.submit)
        self.admission = AdmissionControl(table)
        self.adaptation = AdaptationModule(
            table, self.disbatcher, shrink_fn=shrink_fn, enabled=adaptation_enabled
        )
        self.worker.on_job_complete = self.adaptation.on_job_complete
        # Multi-step decode chunking auto-enables when the table carries a
        # chunk family for any category (i.e. the engine was profiled per
        # depth). Both substrates key off the same table state, so a
        # simulated DeepRT and its live twin make identical depth choices
        # on identical traces — the determinism property the differential
        # harness asserts.
        if table.has_any_chunks():
            self.worker.chunk_policy = ChunkPolicy.from_table(table)
        self.admitted: List[Request] = []
        self.rejected: List[Request] = []
        # Frame-lifecycle tracer (core/telemetry.py); attach_tracer wires
        # the whole pipeline (DisBatcher, EDF worker) in one call.
        self.tracer = None
        self.tracer_tag: Optional[str] = None

    def attach_tracer(self, tracer, tag: Optional[str] = None) -> None:
        """Enable frame-lifecycle tracing across this scheduler's whole
        pipeline. ``tag`` labels the events (the slice name in a
        cluster). ``tracer=None`` detaches — tracing reverts to the
        zero-cost off path."""
        self.tracer = tracer
        self.tracer_tag = tag
        self.worker.tracer = tracer
        self.worker.tracer_tag = tag
        self.disbatcher.tracer = tracer
        self.disbatcher.tracer_tag = tag
        # Devices that carry a measured-completion lane (AsyncDevice —
        # possibly behind a FaultyDevice wrapper) get the tracer too;
        # SequentialDevice defines no ``tracer`` slot and is skipped.
        for dev in (self.device, getattr(self.device, "inner", None)):
            if dev is not None and "tracer" in getattr(dev, "__dict__", {}):
                dev.tracer = tracer
                dev.tracer_tag = tag

    # ----- execution-time plumbing ---------------------------------------
    def _profiled(self, job) -> float:
        if isinstance(job, ChunkJob):
            # The fused dispatch charges the k-step family WCET — to
            # busy_until, the watchdog's expected time, and (via the
            # worker's queued-WCET total before fusing) the gateway's
            # delay estimate.
            return self.table.chunk_wcet(
                job.category.model_id, job.shape_key, job.k
            )
        return self.table.wcet(job.category.model_id, job.shape_key, job.batch_size)

    def _exec_time(self, job: JobInstance) -> float:
        return self.execution.actual_fn(job, self._profiled(job))

    def _on_device_idle(self) -> None:
        self.worker.on_device_idle()

    def _idle_flush(self) -> bool:
        if not self.early_flush:
            return False
        return self.disbatcher.flush_early(
            wcet_fn=lambda cat, shape, b: self.table.wcet(cat.model_id, shape, b)
        )

    def utilization(self) -> float:
        """Current Phase-1 utilization — what the cluster placement loop
        ranks slices by (lowest first) and what its per-slice
        utilization-bound invariant is asserted against."""
        return phase1_from_scheduler(self)

    # ----- client API ------------------------------------------------------
    def submit_request(
        self, request: Request, external_arrivals: bool = False
    ) -> AdmissionResult:
        """Admission-test a pending request at the current time; admit on
        success. ``request.start_time`` below now is clamped to now.

        ``external_arrivals=True`` registers the admitted request with
        the DisBatcher but schedules NO synthetic arrival events: the
        caller (the ingest gateway) owns the frame path and delivers
        real payload-carrying frames via ``ingest_frame``. Admission
        still models the request at its declared period — the gateway's
        load shedder is what reconciles declared rate with reality.
        """
        now = self.loop.now
        if request.start_time < now:
            request.start_time = now
        if not request.category.realtime:
            request.period = max(request.period, NONRT_MIN_PERIOD)
            self._admit(request, external_arrivals)
            return AdmissionResult(admitted=True, phase=0, utilization=0.0,
                                   reason="non-RT: admission bypassed")
        state = snapshot_from_scheduler(
            now=now,
            disbatcher=self.disbatcher,
            queued_jobs=self.worker.queue.snapshot(),
            device_free_at=self.device.busy_until or now,
            table=self.table,
            pending=request,
        )
        result = self.admission.admit(state, self.utilization_bound)
        if result.admitted:
            self._admit(request, external_arrivals)
        else:
            self.rejected.append(request)
        if self.tracer is not None:
            self.tracer.emit(
                T.ADMISSION, now, where=self.tracer_tag,
                cat=str(request.category),
                meta={"request_id": request.request_id,
                      "admitted": result.admitted, "phase": result.phase,
                      "utilization": result.utilization})
        return result

    def _admit(self, request: Request, external_arrivals: bool = False) -> None:
        self.admitted.append(request)
        self.disbatcher.add_request(request)
        if external_arrivals:
            return  # the gateway drives ingest_frame itself
        for i in range(request.n_frames):
            arrival = request.frame_arrival(i)
            self.loop.schedule(
                arrival,
                self._make_arrival(request, i),
                priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
            )

    def _make_arrival(self, request: Request, index: int):
        def _arrive() -> None:
            self.ingest_frame(request, index)
        return _arrive

    def ingest_frame(
        self,
        request: Request,
        index: int,
        payload=None,
        ingest_time: Optional[float] = None,
    ) -> Optional[Frame]:
        """Deliver one frame of an admitted request AT ARRIVAL TIME.

        THE frame entry point — the internal periodic arrivals and the
        ingest gateway's real payload-carrying deliveries both land
        here, so deadline stamping happens at arrival (now +
        relative_deadline), never at dispatch. ``payload`` rides the
        frame to the engine's staging ring; ``ingest_time`` (default:
        now) is when the bytes entered the gateway, the origin for
        end-to-end latency.
        """
        now = self.loop.now
        if getattr(self.device, "closed", False):
            # The slice died. A frame delivered after that can never
            # complete here (the failover tail re-admitted elsewhere
            # serves the stream's future); feeding it to the DisBatcher
            # would count it delivered-and-then-silently-vanished. Count
            # it delivered AND lost so conservation stays falsifiable:
            # completed + dropped + lost == ingested.
            self.metrics.record_ingest()
            self.metrics.record_lost()
            if self.tracer is not None:
                self.tracer.emit(
                    T.LOST, now, request.request_id, index,
                    where=self.tracer_tag, cat=str(request.category),
                    meta={"reason": "device_closed"})
            return None
        frame = Frame(
            request_id=request.request_id,
            category=request.category,
            index=index,
            arrival_time=now,
            deadline=now + request.relative_deadline,
            payload=payload,
            ingest_time=now if ingest_time is None else ingest_time,
        )
        self.disbatcher.on_frame(frame)
        self.metrics.record_ingest()
        if self.tracer is not None:
            self.tracer.emit(
                T.INGEST, now, request.request_id, index,
                where=self.tracer_tag, cat=str(request.category),
                meta={"deadline": frame.deadline,
                      "ingest_time": frame.ingest_time})
        if not request.category.realtime:
            pending = self.disbatcher.pending_frames(request.category)
            if len(pending) >= self.nonrt_batch_cap:
                self.disbatcher._flush(request.category, now)
        # Non-idling: an idle device should not sit on waiting frames.
        if self.device.idle and not self.worker.queue:
            self.worker.on_device_idle()
        return frame

    # ----- run --------------------------------------------------------------
    def run(self, until: Optional[float] = None) -> Metrics:
        self.loop.run(until)
        return self.metrics
