"""Non-idling, non-preemptive EDF execution (paper §3.3, §4.3).

The Worker consumes a deadline-ordered priority queue of job instances and
executes them one at a time on a sequential device. Non-idling: whenever
the device goes idle and the queue is non-empty, the earliest-deadline job
starts immediately; if the queue is empty but frames are waiting in the
DisBatcher, the early-flush optimization fires.

The Worker is also the monitoring point (paper §4.3): it records deadline
misses and reports overruns (actual execution time exceeding the profiled
WCET) to the Adaptation Module.
"""
from __future__ import annotations

import heapq
import math
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core import telemetry as T
from repro_torch.core.bucketing import bucket
from repro_torch.core.faults import TransientSubmitError
from repro_torch.core.request import ChunkJob, JobInstance
from repro_torch.core.simulator import Metrics

#: Retained fused-dispatch decisions (``EDFWorker.chunk_log``). A live
#: worker dispatches for the process lifetime, so the audit trail is a
#: capped deque: old entries evict (counted in ``chunk_log_overflow``).
CHUNK_LOG_CAP = 4096


class DeadlineQueue:
    """Priority queue keyed on absolute deadline (ties: creation order)."""

    def __init__(self):
        self._heap: List[JobInstance] = []

    def push(self, job: JobInstance) -> None:
        heapq.heappush(self._heap, job)

    def pop(self) -> JobInstance:
        return heapq.heappop(self._heap)

    def peek(self) -> JobInstance:
        return self._heap[0]

    def pop_earliest_realtime(self) -> Optional[JobInstance]:
        """Pop the earliest-deadline REAL-TIME job, if any (O(n) scan;
        queues are short). Used when the head is a deferred non-RT job."""
        rt = [j for j in self._heap if j.category.realtime]
        if not rt:
            return None
        target = min(rt)
        self._heap.remove(target)
        heapq.heapify(self._heap)
        return target

    def remove(self, job: JobInstance) -> None:
        """Remove a specific queued job (O(n); used when the worker fuses
        the next k-1 same-category jobs into a decode chunk)."""
        self._heap.remove(job)
        heapq.heapify(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def snapshot(self) -> List[JobInstance]:
        """Jobs currently queued, in deadline order (for admission §4.2)."""
        return sorted(self._heap)


@dataclass
class ChunkPolicy:
    """Slack-driven decode chunk-depth selection for the EDF worker.

    When the earliest-deadline job is a chunkable decode job and the next
    queued jobs continue the same category in deadline order, the worker
    may fuse up to ``max(depths)`` of them into one k-step scanned
    dispatch — IF the head job's deadline slack covers the chunk's full
    profiled WCET plus a safety margin:

        deadline(head) - now >= WCET_chunk(k) + margin

    Near deadlines the rule degenerates to k=1 (plain dispatch); with
    ample slack it picks the deepest profiled depth the queue run-length
    supports. The fused jobs are CONSECUTIVE in deadline order, so EDF
    order is never inverted — a chunk only delays jobs that would have
    waited behind its members anyway, and only by slack the rule proved
    the head could spare. Every inner job's own deadline must also clear
    the chunk (inner deadlines >= head's, head's clears by construction,
    but later members released in the same windows are re-checked so a
    tight straggler degrades the depth rather than miss).
    """

    # job -> True when the category has a chunked program family.
    eligible_fn: Callable[[JobInstance], bool]
    # job -> profiled chunk depths, ascending (must include 1).
    depths_fn: Callable[[JobInstance], List[int]]
    # (job, k) -> profiled WCET of the k-step chunk.
    wcet_fn: Callable[[JobInstance, int], float]
    # job -> safety margin (seconds) the slack must clear on top of the
    # chunk WCET. Default policy: one 1-step WCET of headroom.
    margin_fn: Callable[[JobInstance], float]

    @classmethod
    def from_table(cls, table, margin_steps: float = 1.0) -> "ChunkPolicy":
        """The standard policy over a ProfileTable's chunk families.

        ``margin_steps`` scales the safety margin in units of the
        category's 1-step WCET (default: one step of headroom, so a
        chunk never eats the last step's worth of slack).
        """

        def eligible(job: JobInstance) -> bool:
            return job.category.realtime and table.has_chunks(
                job.category.model_id, job.shape_key
            )

        def depths(job: JobInstance) -> List[int]:
            return table.chunk_depths_profiled(job.category.model_id, job.shape_key)

        def wcet(job: JobInstance, k: int) -> float:
            return table.chunk_wcet(job.category.model_id, job.shape_key, k)

        def margin(job: JobInstance) -> float:
            return margin_steps * table.wcet(
                job.category.model_id, job.shape_key, job.batch_size
            )

        return cls(
            eligible_fn=eligible, depths_fn=depths, wcet_fn=wcet, margin_fn=margin
        )


class EDFWorker:
    """Sequential EDF executor + performance monitor.

    Parameters
    ----------
    device:
        ``SequentialDevice`` — executes one job at a time.
    exec_time_fn:
        job -> actual execution seconds. In simulation this samples the
        "real" execution time (possibly above the profiled WCET: an
        overrun); in live serving it returns the profiled WCET, which
        only seeds the async device's ``busy_until`` estimate (the
        device itself reports the real completion instant).
    profiled_fn:
        job -> profiled WCET seconds (the lookup-table value).
    on_overrun:
        callback(job, excess_seconds) — wired to the Adaptation Module.
    on_underrun:
        callback(job, saved_seconds) — repays adaptation penalty.
    """

    def __init__(
        self,
        loop,
        device,
        exec_time_fn: Callable[[JobInstance], float],
        profiled_fn: Callable[[JobInstance], float],
        metrics: Optional[Metrics] = None,
        on_overrun: Optional[Callable[[JobInstance, float], None]] = None,
        on_underrun: Optional[Callable[[JobInstance, float], None]] = None,
        on_job_complete: Optional[Callable[[JobInstance, float], None]] = None,
        request_idle_work: Optional[Callable[[], bool]] = None,
        next_rt_release_fn: Optional[Callable[[], Optional[float]]] = None,
    ):
        self.loop = loop
        self.device = device
        self.queue = DeadlineQueue()
        self.exec_time_fn = exec_time_fn
        self.profiled_fn = profiled_fn
        self.metrics = metrics if metrics is not None else Metrics()
        self.on_overrun = on_overrun
        self.on_underrun = on_underrun
        self.on_job_complete = on_job_complete
        self.request_idle_work = request_idle_work
        self.next_rt_release_fn = next_rt_release_fn
        self.job_bytes_fn: Optional[Callable[[JobInstance], float]] = None
        # job -> batch-slot rows the execution backend actually ran.
        # Default: the power-of-two prefill bucket. The live bridge
        # overrides it for slot-arena decode, which always executes
        # max_slots rows regardless of the job's batch size.
        self.executed_rows_fn: Optional[Callable[[JobInstance], int]] = None
        self.completed_jobs: List[JobInstance] = []
        # Backoff before re-submitting after a transient device error
        # (seconds; virtual under EventLoop, real under WallClock).
        self.submit_retry_delay = 0.005
        self._retry_scheduled = False  # a future-time retry is pending
        self._dispatch_pending = False  # a same-instant dispatch is pending
        # Running WCET total of queued (not yet started) jobs — O(1)
        # backpressure input for the ingest gateway's per-frame shed
        # decision (summing the queue per arriving frame would be
        # O(queue) on the arrival hot path).
        self.queued_wcet = 0.0
        # Multi-step decode chunking (None = disabled, always k=1).
        self.chunk_policy: Optional[ChunkPolicy] = None
        # (dispatch time, chosen depth, head job_id) per fused dispatch —
        # the determinism harness compares this sequence across the
        # simulated and live substrates. Bounded (see CHUNK_LOG_CAP);
        # evictions are counted, and the O(1) depth histogram below keeps
        # the full-run depth distribution regardless of eviction.
        self.chunk_log: Deque[Tuple[float, int, int]] = deque(maxlen=CHUNK_LOG_CAP)
        self.chunk_log_overflow = 0
        self.chunk_depth_counts: Dict[int, int] = {}
        # Frame-lifecycle tracer (core/telemetry.py). None = tracing off:
        # every hook below is a single identity check on the hot path.
        self.tracer = None
        self.tracer_tag: Optional[str] = None  # slice name in a cluster

    # ----- queue interface (DisBatcher emit target) ---------------------
    def submit(self, job: JobInstance) -> None:
        # Snapshot the charge so the decrement at pop matches even if
        # the table is rescaled (mark_slow) while the job is queued.
        # Non-finite WCETs (a flat entry's inf for an unservable batch)
        # are charged as 0 — adding inf would poison the running total
        # with nan on the matching decrement.
        w = self.profiled_fn(job)
        job._queued_wcet = w if math.isfinite(w) else 0.0
        self.queued_wcet += job._queued_wcet
        self.queue.push(job)
        tr = self.tracer
        if tr is not None:
            now = self.loop.now
            for f in job.frames:
                tr.emit(T.EDF_ENQUEUE, now, f.request_id, f.index,
                        where=self.tracer_tag, cat=str(job.category),
                        meta={"job_id": job.job_id, "deadline": job.deadline})
        self._schedule_dispatch()

    def _schedule_dispatch(self) -> None:
        """Defer the pick-next-job decision to a PRIO_DISPATCH event at the
        current instant, AFTER all same-instant releases/completions have
        been processed. Starting eagerly here could run a long-deadline job
        released a tick before a same-instant tighter release — an EDF
        inversion the admission imitator never models (it releases
        everything with release <= t before popping)."""
        if self._dispatch_pending:
            return
        self._dispatch_pending = True
        self.loop.schedule(
            self.loop.now,
            self._dispatch,
            priority=getattr(self.loop, "PRIO_DISPATCH", 3),
        )

    def _dispatch(self) -> None:
        self._dispatch_pending = False
        self._retry_scheduled = False
        self._maybe_start()

    # ----- execution -----------------------------------------------------
    def _maybe_start(self) -> None:
        if not self.device.idle:
            return
        if not self.queue:
            # Non-idling + early-flush: pull waiting frames forward.
            if self.request_idle_work is not None and self.request_idle_work():
                # flush_early emitted a job via submit() -> already started.
                return
            return
        t_host = _time.perf_counter()
        job = self._pick_job()
        if job is None:
            return
        self.queued_wcet = max(
            0.0, self.queued_wcet - getattr(job, "_queued_wcet", 0.0)
        )
        if self.chunk_policy is not None:
            job = self._maybe_chunk(job)
        job.start_time = self.loop.now
        job.profiled_wcet = self.profiled_fn(job)
        if isinstance(job, ChunkJob):
            # Inner jobs share the chunk's start instant; their per-step
            # WCETs stay the 1-step table values (per-frame accounting).
            for inner in job.jobs:
                inner.start_time = job.start_time
                inner.profiled_wcet = self.profiled_fn(inner)
        actual = self.exec_time_fn(job)
        jb = self.job_bytes_fn(job) if self.job_bytes_fn is not None else 0.0
        try:
            self.device.submit(job, actual, self._on_complete, job_bytes=jb)
        except TransientSubmitError:
            # The device refused the job without damage (driver hiccup /
            # injected fault): the job is NOT lost and NOT failed — requeue
            # it under its original deadline and retry after a short
            # backoff. EDF order is preserved because the queue re-sorts.
            # A refused chunk is UNFUSED first: its members re-enter the
            # queue individually, so the retry re-evaluates depth against
            # the slack remaining after the backoff.
            self.metrics.submit_retries += 1
            members = job.jobs if isinstance(job, ChunkJob) else [job]
            for m in members:
                m.start_time = None
                m.profiled_wcet = None
                self.queued_wcet += getattr(m, "_queued_wcet", 0.0)
                self.queue.push(m)
            if not self._retry_scheduled:
                self._retry_scheduled = True
                self.loop.schedule(
                    self.loop.now + self.submit_retry_delay,
                    self._dispatch,
                    priority=getattr(self.loop, "PRIO_DISPATCH", 3),
                )
            return
        if self.tracer is not None:
            self._trace_dispatch(job)
        if isinstance(job, ChunkJob) and job.k > 1:
            self.metrics.chunk_submits += 1
            self.metrics.chunked_steps += job.k
        # Host-side stall per dispatch: the microseconds spent picking +
        # launching (async devices return immediately from submit) — the
        # metric the hot-path benchmark tracks against the recorded
        # legacy-blocking numbers.
        self.metrics.record_dispatch_overhead(_time.perf_counter() - t_host)

    # ----- telemetry ------------------------------------------------------
    def _trace_dispatch(self, job) -> None:
        """Stamp the dispatch hop (per member frame: the queue->device
        transition plus the profiled WCET the attribution fold caps the
        device stage at) and the device-submit event (per job)."""
        tr = self.tracer
        now = self.loop.now
        tag = self.tracer_tag
        members = job.jobs if isinstance(job, ChunkJob) else [job]
        prof = job.profiled_wcet
        for m in members:
            cat = str(m.category)
            for f in m.frames:
                tr.emit(T.EDF_DISPATCH, now, f.request_id, f.index,
                        where=tag, cat=cat,
                        meta={"job_id": m.job_id, "profiled": prof})
        tr.emit(T.DEVICE_SUBMIT, now, where=tag,
                meta={"job_id": job.job_id, "batch": job.batch_size,
                      "k": getattr(job, "k", 1), "profiled": prof})

    def _trace_terminal(self, frame, now: float) -> None:
        """Exactly one terminal span per completed frame: ``completed``
        at/before its deadline, ``late`` past it (the deadline-miss
        attribution fires inside the tracer on ``late``)."""
        missed = frame.missed
        self.tracer.emit(
            T.LATE if missed else T.COMPLETED, now,
            frame.request_id, frame.index, where=self.tracer_tag,
            cat=str(frame.category),
            meta={"overdue": frame.overdue} if missed else None)

    def _maybe_chunk(self, head: JobInstance):
        """Fuse the picked job with the next queued same-category jobs
        into a k-step decode chunk, depth chosen from deadline slack.

        Returns the (possibly depth-1) ChunkJob for eligible decode jobs
        — so the dispatch path is uniform and the decision is logged —
        or the plain job when the category has no chunk family. Only
        CONSECUTIVE earliest-deadline queued jobs are taken: the scan
        over the deadline-ordered snapshot stops at the first job of a
        different category, so fusing never leapfrogs a tighter job of
        another stream.
        """
        pol = self.chunk_policy
        if not pol.eligible_fn(head):
            return head
        depths = pol.depths_fn(head)
        if not depths:
            return head
        now = self.loop.now
        run = [head]
        max_depth = max(depths)
        for j in self.queue.snapshot():
            if len(run) >= max_depth:
                break
            if j.category != head.category or not pol.eligible_fn(j):
                break
            run.append(j)
        chosen = 1
        for d in depths:
            if d > len(run):
                break
            w = pol.wcet_fn(head, d)
            if not math.isfinite(w):
                break
            need = w + pol.margin_fn(head)
            # Every member of the candidate chunk must clear it — the
            # head (earliest deadline) usually binds, but a member with
            # a tight deadline released late degrades the depth.
            if all(j.deadline - now >= need - 1e-12 for j in run[:d]):
                chosen = d
        if len(self.chunk_log) == CHUNK_LOG_CAP:
            self.chunk_log_overflow += 1
        self.chunk_log.append((now, chosen, head.job_id))
        self.chunk_depth_counts[chosen] = (
            self.chunk_depth_counts.get(chosen, 0) + 1
        )
        if self.tracer is not None:
            self.tracer.emit(
                T.CHUNK_FUSE, now, where=self.tracer_tag,
                cat=str(head.category),
                meta={"depth": chosen, "head_job_id": head.job_id,
                      "run": len(run)})
        for extra in run[1:chosen]:
            self.queue.remove(extra)
            self.queued_wcet = max(
                0.0, self.queued_wcet - getattr(extra, "_queued_wcet", 0.0)
            )
        return ChunkJob(run[:chosen])

    def _pick_job(self) -> Optional[JobInstance]:
        """EDF pop, with a background-server guard for non-RT jobs.

        A non-RT job may only start if it completes before the earliest
        upcoming real-time window joint; otherwise its non-preemptive
        execution would inject blocking the admission test never modeled
        (paper §3.3 bounds this inversion via a large imposed period — we
        eliminate it entirely). A deferred non-RT job is retried when the
        blocking release has passed.
        """
        head = self.queue.peek()
        if head.category.realtime:
            return self.queue.pop()
        next_rt = (
            self.next_rt_release_fn() if self.next_rt_release_fn is not None else None
        )
        if next_rt is None:
            return self.queue.pop()
        wcet = self.profiled_fn(head)
        if self.loop.now + wcet <= next_rt + 1e-12:
            return self.queue.pop()
        rt_job = self.queue.pop_earliest_realtime()
        if rt_job is not None:
            return rt_job
        # Everything queued is non-RT and unsafe to start: retry at the
        # blocking release (PRIO_DISPATCH orders it after that joint fires).
        if not self._retry_scheduled:
            self._retry_scheduled = True
            self.loop.schedule(
                next_rt,
                self._dispatch,
                priority=getattr(self.loop, "PRIO_DISPATCH", 3),
            )
        return None

    def on_device_idle(self) -> None:
        self._schedule_dispatch()

    def _on_complete(self, job: JobInstance, now: float) -> None:
        if job.completion_time is not None:
            # Duplicated completion signal (a retried ack — see
            # ``faults.DUP_COMPLETE``). The first signal already recorded
            # the job, its frames, the adaptation hooks, and any chained
            # lease release; a second pass would double-count all of
            # them, so the duplicate is counted and dropped here.
            self.metrics.duplicate_completions += 1
            return
        job.completion_time = now
        actual = now - job.start_time
        tr = self.tracer
        if tr is not None:
            tr.emit(T.DEVICE_COMPLETE, now, where=self.tracer_tag,
                    meta={"job_id": job.job_id, "dur": actual,
                          "k": getattr(job, "k", 1),
                          "profiled": job.profiled_wcet})
        if isinstance(job, ChunkJob):
            # Fan the single device completion back out to the chunk's
            # member jobs IN ORDER: each keeps its own frames, deadlines,
            # and adaptation attribution. The per-member actual is the
            # chunk's even per-step share — the adaptation module
            # compares it against the 1-step table WCET, and charging a
            # member the whole chunk time would register a k× phantom
            # overrun on every fused dispatch.
            share = actual / job.k
            for inner in job.jobs:
                inner.completion_time = now
                self.completed_jobs.append(inner)
                rows = (
                    self.executed_rows_fn(inner)
                    if self.executed_rows_fn is not None
                    else bucket(inner.batch_size)
                )
                self.metrics.record_job(inner.batch_size, rows)
                for f in inner.frames:
                    f.completion_time = now
                    self.metrics.record_frame(f)
                    if tr is not None:
                        self._trace_terminal(f, now)
                if self.on_job_complete is not None:
                    self.on_job_complete(inner, share)
            # Overrun/underrun is judged ONCE, chunk actual vs chunk
            # WCET (attributed to the head member below).
        else:
            self.completed_jobs.append(job)
            # Charge the batch-slot rows that actually executed (prefill:
            # the power-of-two bucket; arena decode: max_slots, via the
            # bridge's executed_rows_fn override).
            rows = (
                self.executed_rows_fn(job)
                if self.executed_rows_fn is not None
                else bucket(job.batch_size)
            )
            self.metrics.record_job(job.batch_size, rows)
            for f in job.frames:
                f.completion_time = now
                self.metrics.record_frame(f)
                if tr is not None:
                    self._trace_terminal(f, now)
            if self.on_job_complete is not None:
                self.on_job_complete(job, actual)
        if job.profiled_wcet is not None:
            if actual > job.profiled_wcet + 1e-9:
                self.metrics.overruns += 1
                if self.on_overrun is not None:
                    self.on_overrun(job, actual - job.profiled_wcet)
            elif actual < job.profiled_wcet - 1e-9:
                if self.on_underrun is not None:
                    self.on_underrun(job, job.profiled_wcet - actual)
        # Device calls on_idle -> on_device_idle -> dispatch, via the
        # scheduler wiring; also schedule directly for standalone use.
        if self.device.on_idle is None:
            self._schedule_dispatch()
