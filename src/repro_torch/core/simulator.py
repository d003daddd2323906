"""Discrete-event simulation engine.

Three roles in the reproduction:

1. Virtual clock for the DeepRT scheduler and every baseline, so the
   paper's trace experiments (Figs 4/5/7/10) run deterministically and
   orders of magnitude faster than wall time.
2. The device models: ``SequentialDevice`` (a TPU core: one program at a
   time — also how DeepRT drives a GPU) and ``ProcessorSharingDevice``
   (CUDA time-sliced context multiplexing, reproducing the paper's Fig 2a
   linear-slowdown observation; used only by the concurrent baselines and
   the §2 characterization benchmark).
3. Wall-clock mode: ``WallClock`` swaps in for real serving; the scheduler
   code is identical.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.telemetry import LatencyHistogram


class EventLoop:
    """Heap-based virtual-time event loop.

    Events at the SAME timestamp execute in (priority, insertion) order.
    Priorities make same-instant semantics deterministic and independent
    of insertion order — crucial at window-joint boundaries:

      PRIO_ARRIVAL(0) < PRIO_COMPLETE(1) < PRIO_JOINT(2) < PRIO_DISPATCH(3)

    A frame arriving exactly at a window joint therefore joins the window
    that closes at that instant, and the EDF worker only picks its next
    job (PRIO_DISPATCH) after ALL same-instant releases have been pushed —
    the same conventions the Phase-2 EDF imitator uses (it releases every
    job with release <= t before popping).
    """

    PRIO_ARRIVAL = 0
    PRIO_COMPLETE = 1
    PRIO_JOINT = 2
    PRIO_DISPATCH = 3

    def __init__(self, start: float = 0.0):
        self._now = start
        self._heap: list = []
        self._seq = itertools.count()
        self._cancelled: set = set()

    @property
    def now(self) -> float:
        return self._now

    def schedule(
        self, when: float, fn: Callable[[], None], priority: int = 1
    ) -> int:
        if when < self._now - 1e-12:
            raise ValueError(f"cannot schedule in the past: {when} < {self._now}")
        eid = next(self._seq)
        heapq.heappush(self._heap, (max(when, self._now), priority, eid, fn))
        return eid

    def schedule_in(
        self, delay: float, fn: Callable[[], None], priority: int = 1
    ) -> int:
        return self.schedule(self._now + delay, fn, priority)

    def cancel(self, event_id: int) -> None:
        self._cancelled.add(event_id)

    def run(self, until: Optional[float] = None) -> None:
        while self._heap:
            when, _prio, eid, fn = self._heap[0]
            if until is not None and when > until:
                break
            heapq.heappop(self._heap)
            if eid in self._cancelled:
                self._cancelled.discard(eid)
                continue
            self._now = when
            fn()
        if until is not None and until > self._now:
            self._now = until

    def peek_time(self) -> Optional[float]:
        while self._heap and self._heap[0][2] in self._cancelled:
            _, _, eid, _ = heapq.heappop(self._heap)
            self._cancelled.discard(eid)
        return self._heap[0][0] if self._heap else None


class WallClock:
    """Wall-clock stand-in with the same scheduling interface.

    Used by the live serving path (examples/serve_multitenant.py).
    Callbacks execute on the thread that called ``run``; ``run`` sleeps on
    a condition variable until *exactly* the next event time (no coarse
    polling granularity — live window joints fire on time) and wakes
    immediately when another thread posts work via ``post``.

    Cross-thread protocol (used by ``serving.async_device.AsyncDevice``):
    - ``post(fn, priority)``    — thread-safe "schedule at now + wake up";
    - ``hold()`` / ``release()``— keep ``run`` alive while external work
      (an in-flight device execution) will post a future completion even
      though the heap is momentarily empty.
    """

    PRIO_ARRIVAL = 0
    PRIO_COMPLETE = 1
    PRIO_JOINT = 2
    PRIO_DISPATCH = 3

    def __init__(self):
        self._t0 = _time.perf_counter()
        self._heap: list = []
        self._seq = itertools.count()
        self._cancelled: set = set()
        self._cond = threading.Condition()
        self._holds = 0

    @property
    def now(self) -> float:
        return _time.perf_counter() - self._t0

    def schedule(self, when: float, fn: Callable[[], None], priority: int = 1) -> int:
        with self._cond:
            eid = next(self._seq)
            heapq.heappush(self._heap, (when, priority, eid, fn))
            self._cond.notify_all()
            return eid

    def schedule_in(self, delay: float, fn: Callable[[], None], priority: int = 1) -> int:
        return self.schedule(self.now + delay, fn, priority)

    def post(self, fn: Callable[[], None], priority: int = 1) -> int:
        """Thread-safe: enqueue ``fn`` at the current instant and wake the
        loop thread. The completion path of the async device."""
        return self.schedule(self.now, fn, priority)

    def hold(self) -> None:
        with self._cond:
            self._holds += 1

    def release(self) -> None:
        with self._cond:
            if self._holds <= 0:
                raise RuntimeError("WallClock.release() without a matching hold()")
            self._holds -= 1
            self._cond.notify_all()

    def cancel(self, event_id: int) -> None:
        self._cancelled.add(event_id)

    def run(self, until: Optional[float] = None) -> None:
        while True:
            fn = None
            with self._cond:
                while True:
                    if self._heap:
                        when, _prio, eid, _fn = self._heap[0]
                        if until is not None and when > until:
                            return
                        wait = when - self.now
                        if wait <= 0:
                            heapq.heappop(self._heap)
                            if eid in self._cancelled:
                                self._cancelled.discard(eid)
                                continue
                            fn = _fn
                            break
                        # Sleep until exactly the next event (or a post()).
                        self._cond.wait(timeout=wait)
                    elif self._holds > 0:
                        # Heap empty but a device execution is in flight;
                        # its completion will be post()ed from the waiter.
                        if until is not None and self.now > until:
                            return
                        self._cond.wait(timeout=0.05)
                    else:
                        return
            # Execute outside the lock: callbacks may schedule() freely.
            fn()


@dataclass
class _Active:
    job: object
    work: float  # remaining isolated-execution seconds
    on_complete: Callable[[object, float], None]
    job_bytes: float = 0.0


class SequentialDevice:
    """One program at a time — a TPU core, or DeepRT's view of the GPU.

    ``submit`` is only legal when idle; the caller (the EDF worker)
    enforces non-preemptive sequential execution.

    THE DEVICE CONTRACT — shared by this simulated device and the live
    ``repro.serving.async_device.AsyncDevice`` (and anything future PRs
    add: multi-device sharding, cluster slices):

    - ``submit(job, exec_time, on_complete, job_bytes=0.0)``: start one
      job. ``exec_time`` is the caller's best estimate (simulation: the
      sampled "actual"; live: the profiled WCET) — it drives
      ``busy_until`` and, for simulated devices only, the completion
      instant. ``on_complete(job, now)`` fires exactly once, on the loop
      thread, at the job's completion time.
    - ``idle`` / ``busy_until``: scheduling state the EDF worker and the
      admission snapshot read; ``busy_until`` is an estimate for live
      devices (actual completion may land earlier or later).
    - ``on_idle``: zero-arg callback invoked after each completion; the
      scheduler wires it to the EDF worker's dispatch.

    The whole point of the contract is that host-side scheduling overlaps
    device execution identically in simulation and live serving: the
    simulated loop keeps processing events while a job "runs", and the
    async device keeps the wall-clock loop free while XLA executes.
    """

    def __init__(self, loop: EventLoop, on_idle: Optional[Callable[[], None]] = None):
        self.loop = loop
        self.on_idle = on_idle
        self._busy_until: Optional[float] = None
        self._closed = False
        self.busy_time = 0.0  # total seconds spent executing
        self.resident_bytes = 0.0  # live batch buffers (Fig 6 benchmark)
        self.peak_bytes = 0.0

    @property
    def idle(self) -> bool:
        # A closed device (its slice failed) is never idle — see
        # AsyncDevice.idle for the rationale; both contract
        # implementations fail-stop identically.
        return not self._closed and self._busy_until is None

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def busy_until(self) -> Optional[float]:
        return self._busy_until

    def close(self) -> None:
        """Fail-stop (idempotent): refuse new submissions, report
        not-idle forever, swallow the in-flight completion if any. The
        cluster's ``fail_slice`` closes the dead slice's device so its
        remaining frames are lost with the slice in simulation exactly
        as they are live — otherwise the sim slice would keep serving
        the frames its re-admitted tails also serve, double-counting
        them in the aggregate metrics."""
        self._closed = True

    def submit(
        self,
        job: object,
        exec_time: float,
        on_complete: Callable[[object, float], None],
        job_bytes: float = 0.0,
    ) -> None:
        if self._closed:
            raise RuntimeError("SequentialDevice is closed (slice failed)")
        if not self.idle:
            raise RuntimeError("SequentialDevice is busy; EDF worker bug")
        start = self.loop.now
        self._busy_until = start + exec_time
        self.busy_time += exec_time
        self.resident_bytes += job_bytes
        self.peak_bytes = max(self.peak_bytes, self.resident_bytes)

        def _done() -> None:
            self._busy_until = None
            self.resident_bytes -= job_bytes
            if self._closed:
                return  # slice died mid-job: frames lost with the slice
            on_complete(job, self.loop.now)
            if self.on_idle is not None:
                self.on_idle()

        self.loop.schedule(start + exec_time, _done, priority=EventLoop.PRIO_COMPLETE)


class ProcessorSharingDevice:
    """CUDA time-sliced context multiplexing (paper §2.2, Fig 2a).

    k concurrently resident jobs each progress at rate 1/k: a job whose
    isolated execution time is w completes after accumulating w seconds of
    service. This reproduces the paper's measured linear growth of
    execution time with concurrency. Used by the AIMD / BATCH /
    BATCH-Delay baselines, which execute categories concurrently, and by
    the §2 characterization benchmark.
    """

    def __init__(self, loop: EventLoop, interference: float = 1.0):
        # interference > 1 models cross-model slowdown beyond pure
        # time-slicing (paper Table 1 shows >k slowdowns for some pairs).
        self.loop = loop
        self.interference = interference
        self._active: List[_Active] = []
        self._last_update = 0.0
        self._completion_event: Optional[int] = None
        self.busy_time = 0.0
        self.peak_bytes = 0.0

    @property
    def n_active(self) -> int:
        return len(self._active)

    def _rate(self) -> float:
        k = len(self._active)
        if k == 0:
            return 0.0
        if k == 1:
            return 1.0
        return 1.0 / (k * self.interference)

    def _drain(self) -> None:
        now = self.loop.now
        dt = now - self._last_update
        if dt > 0 and self._active:
            r = self._rate()
            for a in self._active:
                a.work -= dt * r
            self.busy_time += dt
        self._last_update = now

    def _reschedule(self) -> None:
        if self._completion_event is not None:
            self.loop.cancel(self._completion_event)
            self._completion_event = None
        if not self._active:
            return
        r = self._rate()
        nxt = min(self._active, key=lambda a: a.work)
        eta = max(nxt.work, 0.0) / r
        self._completion_event = self.loop.schedule_in(eta, self._complete_front)

    def _complete_front(self) -> None:
        self._drain()
        self._completion_event = None
        done = [a for a in self._active if a.work <= 1e-12]
        self._active = [a for a in self._active if a.work > 1e-12]
        for a in done:
            a.on_complete(a.job, self.loop.now)
        self._reschedule()

    def submit(
        self,
        job: object,
        exec_time: float,
        on_complete: Callable[[object, float], None],
        job_bytes: float = 0.0,
    ) -> None:
        self._drain()
        self._active.append(_Active(job, exec_time, on_complete, job_bytes))
        self.peak_bytes = max(
            self.peak_bytes, sum(a.job_bytes for a in self._active)
        )
        self._reschedule()


@dataclass
class Metrics:
    """Per-run metrics shared by DeepRT and all baselines.

    Latency distributions are kept in STREAMING log-bucket histograms
    (``latency_hist``/``e2e_hist`` — O(1) memory under millions of
    frames; exact means, percentiles within one bucket growth factor).
    The raw per-sample lists (``frame_latencies``, ``e2e_latencies``,
    ``overdue_times``, ``dispatch_overheads``, ``batch_sizes``) and the
    per-frame ``frame_records`` dict grow with frames served and are
    only populated while ``record_samples`` is True (the default, for
    tests and short benchmark runs); long-lived servers set it False and
    every aggregate below still reads exactly the same values from the
    histograms and running sums.
    """

    record_samples: bool = True
    completed_frames: int = 0
    missed_frames: int = 0
    overdue_times: List[float] = field(default_factory=list)
    frame_latencies: List[float] = field(default_factory=list)
    job_count: int = 0
    batch_sizes: List[int] = field(default_factory=list)
    # Padding accounting: real frames vs. executed bucket slots per job.
    real_rows: int = 0
    bucket_rows: int = 0
    # Host-side scheduler time per dispatch decision (seconds) — the time
    # the event loop is stalled picking + submitting a job. Async dispatch
    # keeps this at microseconds; the deleted legacy blocking path used to
    # stall here for the whole device execution (the recorded numbers the
    # hot-path benchmark replays as its before-arm).
    dispatch_overheads: List[float] = field(default_factory=list)
    overruns: int = 0
    first_arrival: Optional[float] = None
    last_completion: float = 0.0
    peak_resident_bytes: float = 0.0
    # (request_id, frame_index) -> (arrival, deadline, completion)
    frame_records: Dict = field(default_factory=dict)
    # True end-to-end latency: gateway ingest -> completion. Identical to
    # ``frame_latencies`` (scheduler arrival -> completion) unless the
    # ingest gateway queued or deferred the frame upstream.
    e2e_latencies: List[float] = field(default_factory=list)
    # Load-shedding accounting: every frame the gateway drops is counted
    # here (never silently vanished) — total and per request stream.
    dropped_frames: int = 0
    drops_by_request: Dict[int, int] = field(default_factory=dict)
    # Deadline misses per request stream: lets a cohort (e.g. the
    # transport churn benchmark's live sessions) compute its own
    # effective miss rate without per-frame sample recording.
    missed_by_request: Dict[int, int] = field(default_factory=dict)
    # Frames handed to the scheduler (``DeepRT.ingest_frame``), counted
    # INDEPENDENTLY of completions so the conservation property below is
    # falsifiable — a delivered frame the scheduler loses shows up as
    # completed + dropped < ingested.
    delivered_frames: int = 0
    # Slot-mode decode can consume ONE token per stream per step: when a
    # window batches two frames of the same decode stream, the later
    # token cannot be staged this step and is counted here (the frames
    # still complete — this is a visible degradation signal, the cue to
    # shorten windows or shed harder, never a silent overwrite).
    payload_collisions: int = 0
    # Frames that died with their slice: either in the pipeline (delivered
    # but never completed when the slice was failed — reconciled once by
    # ``fail_slice``) or refused at a closed device (counted delivered AND
    # lost, so ``ingested`` still covers them). Conservation for a drained
    # failure run: ``completed + dropped + lost == ingested``.
    lost_frames: int = 0
    # Submits the EDF worker retried after a transient device error.
    submit_retries: int = 0
    # Completion signals that arrived for an already-completed job
    # (``faults.DUP_COMPLETE``): suppressed by the EDF worker's
    # idempotency guard instead of double-counting frames/leases.
    duplicate_completions: int = 0
    # Multi-step decode chunking (``EDFWorker.chunk_policy``): fused
    # dispatches of depth >= 2, and the total decode steps they carried.
    # ``chunked_steps / chunk_submits`` is the mean depth the slack rule
    # actually achieved — the amortization the benchmark measures.
    chunk_submits: int = 0
    chunked_steps: int = 0
    # Streaming latency distributions (always on; O(1) memory).
    latency_hist: LatencyHistogram = field(default_factory=LatencyHistogram)
    e2e_hist: LatencyHistogram = field(default_factory=LatencyHistogram)
    # Running sums backing the means when sample lists are off.
    dispatch_overhead_sum: float = 0.0
    dispatch_count: int = 0

    def record_frame(self, frame) -> None:
        self.completed_frames += 1
        if self.first_arrival is None or frame.arrival_time < self.first_arrival:
            self.first_arrival = frame.arrival_time
        self.last_completion = max(self.last_completion, frame.completion_time)
        e2e = getattr(frame, "e2e_latency", None)
        e2e = e2e if e2e is not None else frame.latency
        self.latency_hist.record(frame.latency)
        self.e2e_hist.record(e2e)
        if self.record_samples:
            self.frame_latencies.append(frame.latency)
            self.e2e_latencies.append(e2e)
            self.frame_records[(frame.request_id, frame.index)] = (
                frame.arrival_time,
                frame.deadline,
                frame.completion_time,
            )
        if frame.missed:
            self.missed_frames += 1
            self.missed_by_request[frame.request_id] = (
                self.missed_by_request.get(frame.request_id, 0) + 1
            )
            if self.record_samples:
                self.overdue_times.append(frame.overdue)

    def record_ingest(self) -> None:
        """One frame delivered into the scheduler at arrival."""
        self.delivered_frames += 1

    def record_drop(self, request_id: int) -> None:
        """One ingested frame shed by the gateway before scheduling."""
        self.dropped_frames += 1
        self.drops_by_request[request_id] = (
            self.drops_by_request.get(request_id, 0) + 1
        )

    def record_lost(self, n: int = 1) -> None:
        """``n`` delivered frames died with a failed slice."""
        self.lost_frames += n

    def record_job(self, batch_size: int, bucket_size: Optional[int] = None) -> None:
        """``bucket_size`` is the executed batch-slot count; callers whose
        execution model pads (the EDF worker over the bucketing engine)
        pass it explicitly. Default = no padding (baselines on the
        processor-sharing device run true batch sizes)."""
        self.job_count += 1
        if self.record_samples:
            self.batch_sizes.append(batch_size)
        self.real_rows += batch_size
        self.bucket_rows += bucket_size if bucket_size is not None else batch_size

    def record_dispatch_overhead(self, seconds: float) -> None:
        self.dispatch_overhead_sum += seconds
        self.dispatch_count += 1
        if self.record_samples:
            self.dispatch_overheads.append(seconds)

    @property
    def miss_rate(self) -> float:
        if self.completed_frames == 0:
            return 0.0
        return self.missed_frames / self.completed_frames

    @property
    def throughput(self) -> float:
        """Completed frames per second of makespan."""
        if self.completed_frames == 0 or self.first_arrival is None:
            return 0.0
        span = self.last_completion - self.first_arrival
        return self.completed_frames / span if span > 0 else float("inf")

    @property
    def mean_batch(self) -> float:
        # real_rows is exactly sum(batch_sizes): the running-sum form
        # keeps this exact with record_samples=False.
        return self.real_rows / self.job_count if self.job_count else 0.0

    @property
    def padding_waste(self) -> float:
        """Fraction of executed batch-bucket slots carrying no real frame."""
        if self.bucket_rows == 0:
            return 0.0
        return 1.0 - self.real_rows / self.bucket_rows

    @property
    def mean_latency(self) -> float:
        """Mean scheduler-arrival -> completion latency (seconds)."""
        return self.latency_hist.mean

    @property
    def mean_e2e_latency(self) -> float:
        """Mean gateway-ingest -> completion latency (seconds)."""
        return self.e2e_hist.mean

    def latency_percentile(self, q: float) -> float:
        """Streaming scheduler-latency quantile (log-bucket estimate)."""
        return self.latency_hist.percentile(q)

    def e2e_percentile(self, q: float) -> float:
        """Streaming end-to-end-latency quantile (log-bucket estimate)."""
        return self.e2e_hist.percentile(q)

    @property
    def ingested_frames(self) -> int:
        """Everything the gateway accepted bytes for: delivered (counted
        at ``record_ingest``, i.e. scheduler arrival) + shed. The
        conservation check ``completed + dropped == ingested`` is
        FALSIFIABLE for a drained ingest-path run: it fails if the
        scheduler ever loses a delivered frame. Runs that fail slices
        extend it to ``completed + dropped + lost == ingested`` — every
        frame that died with a slice is counted in ``lost_frames``.
        (Baselines that record completions without the ingest path leave
        this at dropped-only.)
        """
        return self.delivered_frames + self.dropped_frames

    @property
    def mean_dispatch_overhead(self) -> float:
        """Mean host-side scheduler stall per job dispatch (seconds)."""
        if self.dispatch_count == 0:
            return 0.0
        return self.dispatch_overhead_sum / self.dispatch_count
