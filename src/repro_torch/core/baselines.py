"""Baseline schedulers the paper compares against (§6.2, §6.3).

- AIMD       — Clipper/MArk adaptive batching: additive batch-size increase
               while latency meets the objective, multiplicative decrease on
               violation. Categories execute *concurrently* (one virtual
               model instance per category, processor-sharing device).
- BATCH      — Triton static batching: fixed batch size per category,
               execute as soon as the batch fills. Concurrent.
- BATCHDelay — Triton with max queue delay: fixed batch size OR timeout,
               whichever first. Concurrent.
- SEDF       — Sequential EDF: per-frame jobs (no batching) on a sequential
               device, EDF order, with an EDF-imitator admission test
               (paper §6.3 builds exactly this as the RT comparator).

All baselines run on the same event loop / trace / profiler inputs as
DeepRT, and produce the same Metrics, so the benchmark harness is a strict
apples-to-apples reproduction of the paper's comparison methodology. The
processor-sharing device reproduces the paper's Fig-2a observation that
concurrent CUDA contexts time-slice (execution time grows ~linearly in the
number of resident jobs).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.admission import AdmissionControl
from repro_torch.core.profiler import ProfileTable
from repro_torch.core.request import Category, Frame, PseudoJob, Request
from repro_torch.core.simulator import (
    EventLoop,
    Metrics,
    ProcessorSharingDevice,
    SequentialDevice,
)


@dataclass
class _BatchJob:
    category: Category
    frames: List[Frame]
    created: float

    @property
    def batch_size(self) -> int:
        return len(self.frames)


class _ConcurrentBaseline:
    """Shared machinery for AIMD / BATCH / BATCH-Delay."""

    def __init__(
        self,
        table: ProfileTable,
        loop: Optional[EventLoop] = None,
        actual_fn: Optional[Callable] = None,
        interference: float = 1.0,
    ):
        self.loop = loop if loop is not None else EventLoop()
        self.table = table
        self.device = ProcessorSharingDevice(self.loop, interference=interference)
        self.metrics = Metrics()
        self.actual_fn = actual_fn or (lambda job, wcet: 0.97 * wcet)
        self._queues: Dict[Category, List[Frame]] = {}
        self._busy: Dict[Category, bool] = {}
        self.admitted: List[Request] = []
        self.job_bytes_fn = None  # optional: job -> bytes (Fig 6 benchmark)

    # Baselines have no admission control (paper §6.2).
    def submit_request(self, request: Request) -> None:
        self.admitted.append(request)
        self._queues.setdefault(request.category, [])
        self._busy.setdefault(request.category, False)
        for i in range(request.n_frames):
            self.loop.schedule(
                request.frame_arrival(i), self._make_arrival(request, i)
            )

    def _make_arrival(self, request: Request, index: int):
        def _arrive() -> None:
            frame = Frame(
                request_id=request.request_id,
                category=request.category,
                index=index,
                arrival_time=self.loop.now,
                deadline=self.loop.now + request.relative_deadline,
            )
            self._queues[request.category].append(frame)
            self._poll(request.category)
        return _arrive

    def _poll(self, cat: Category) -> None:
        raise NotImplementedError

    def _launch(self, cat: Category, frames: List[Frame]) -> None:
        job = _BatchJob(cat, frames, self.loop.now)
        wcet = self.table.wcet(cat.model_id, cat.shape_key, len(frames))
        actual = self.actual_fn(job, wcet)
        self._busy[cat] = True
        jb = self.job_bytes_fn(job) if self.job_bytes_fn is not None else 0.0
        self.device.submit(job, actual, self._on_complete, job_bytes=jb)

    def _on_complete(self, job: _BatchJob, now: float) -> None:
        self.metrics.record_job(job.batch_size)
        for f in job.frames:
            f.completion_time = now
            self.metrics.record_frame(f)
        self._busy[job.category] = False
        self._after_complete(job, now)
        self._poll(job.category)

    def _after_complete(self, job: _BatchJob, now: float) -> None:
        pass

    def run(self, until: Optional[float] = None) -> Metrics:
        self.loop.run(until)
        return self.metrics


class AIMD(_ConcurrentBaseline):
    """Clipper-style AIMD adaptive batching (paper baseline #1)."""

    def __init__(self, *args, additive: int = 1, multiplicative: float = 2.0, **kw):
        super().__init__(*args, **kw)
        self.additive = additive
        self.multiplicative = multiplicative
        self._batch_size: Dict[Category, int] = {}
        self._slo: Dict[Category, float] = {}

    def submit_request(self, request: Request) -> None:
        cat = request.category
        self._batch_size.setdefault(cat, 1)
        slo = self._slo.get(cat, float("inf"))
        self._slo[cat] = min(slo, request.relative_deadline)
        super().submit_request(request)

    def _poll(self, cat: Category) -> None:
        q = self._queues[cat]
        if not q or self._busy[cat]:
            return
        b = min(self._batch_size[cat], len(q))
        frames, self._queues[cat] = q[:b], q[b:]
        self._launch(cat, frames)

    def _after_complete(self, job: _BatchJob, now: float) -> None:
        cat = job.category
        # Latency of the batch = oldest member frame's response time.
        latency = max(now - f.arrival_time for f in job.frames)
        if latency <= self._slo.get(cat, float("inf")):
            self._batch_size[cat] = self._batch_size[cat] + self.additive
        else:
            self._batch_size[cat] = max(
                1, int(self._batch_size[cat] / self.multiplicative)
            )


class BATCH(_ConcurrentBaseline):
    """Triton static batching: run when ``batch_size`` frames accumulate.

    Also fires a partial batch when no more frames can ever arrive for the
    category (end of trace), so runs terminate.
    """

    def __init__(self, *args, batch_size: int = 4, **kw):
        super().__init__(*args, **kw)
        self.batch_size = batch_size
        self._last_arrival: Dict[Category, float] = {}

    def submit_request(self, request: Request) -> None:
        cat = request.category
        last = self._last_arrival.get(cat, 0.0)
        self._last_arrival[cat] = max(last, request.end_time)
        super().submit_request(request)
        # Drain stragglers after the last possible arrival.
        self.loop.schedule(
            self._last_arrival[cat] + 1e-6, lambda: self._poll(cat, drain=True)
        )

    def _poll(self, cat: Category, drain: bool = False) -> None:
        q = self._queues[cat]
        if self._busy[cat] or not q:
            return
        drain = drain or self.loop.now >= self._last_arrival.get(cat, 0.0)
        if len(q) >= self.batch_size or (drain and q):
            b = min(self.batch_size, len(q))
            frames, self._queues[cat] = q[:b], q[b:]
            self._launch(cat, frames)


class BATCHDelay(BATCH):
    """Triton with max queue delay: batch fills OR timeout expires."""

    def __init__(self, *args, batch_size: int = 4, max_delay: float = 0.05, **kw):
        super().__init__(*args, batch_size=batch_size, **kw)
        self.max_delay = max_delay

    def _make_arrival(self, request: Request, index: int):
        base = super()._make_arrival(request, index)

        def _arrive() -> None:
            base()
            cat = request.category
            # A timeout anchored to this frame's arrival.
            self.loop.schedule_in(self.max_delay, lambda: self._timeout(cat))
        return _arrive

    def _timeout(self, cat: Category) -> None:
        q = self._queues[cat]
        if q and not self._busy[cat]:
            oldest = min(f.arrival_time for f in q)
            if self.loop.now - oldest >= self.max_delay - 1e-9:
                b = min(self.batch_size, len(q))
                frames, self._queues[cat] = q[:b], q[b:]
                self._launch(cat, frames)


class SEDF:
    """Sequential EDF without batching (paper §6.3's RT comparator)."""

    def __init__(
        self,
        table: ProfileTable,
        loop: Optional[EventLoop] = None,
        actual_fn: Optional[Callable] = None,
    ):
        self.loop = loop if loop is not None else EventLoop()
        self.table = table
        self.metrics = Metrics()
        self.actual_fn = actual_fn or (lambda job, wcet: 0.97 * wcet)
        self.device = SequentialDevice(self.loop, on_idle=self._maybe_start)
        self._queue: List = []  # heap of (deadline, seq, frame)
        self._seq = 0
        self.admission = AdmissionControl(table)
        self.admitted: List[Request] = []
        self.rejected: List[Request] = []

    # -- admission: EDF imitator over per-frame pseudo jobs ---------------
    def _pseudo_jobs(self, requests: List[Request], now: float) -> List[PseudoJob]:
        jobs = []
        for r in requests:
            e = self.table.wcet(r.category.model_id, r.category.shape_key, 1)
            first = 0
            if r.start_time < now:
                first = int(math.ceil((now - r.start_time) / r.period))
            for i in range(first, r.n_frames):
                a = r.frame_arrival(i)
                jobs.append(
                    PseudoJob(
                        category=r.category,
                        release_time=a,
                        exec_time=e,
                        relative_deadline=r.relative_deadline,
                        n_frames=1,
                        frame_refs=((a, a + r.relative_deadline, r.request_id, i),),
                    )
                )
        jobs.sort(key=lambda j: (j.release_time, j.deadline))
        return jobs

    def submit_request(self, request: Request) -> bool:
        now = self.loop.now
        if request.start_time < now:
            request.start_time = now
        live = [r for r in self.admitted if r.end_time >= now]
        jobs = self._pseudo_jobs(live + [request], now)
        # Frames already queued:
        for dl, _, f in self._queue:
            e = self.table.wcet(f.category.model_id, f.category.shape_key, 1)
            jobs.append(PseudoJob(f.category, now, e, dl - now, 1))
        jobs.sort(key=lambda j: (j.release_time, j.deadline))
        ok, _ = self.admission.edf_imitator(
            jobs, start_time=max(now, self.device.busy_until or now)
        )
        if not ok:
            self.rejected.append(request)
            return False
        self.admitted.append(request)
        for i in range(request.n_frames):
            self.loop.schedule(
                request.frame_arrival(i), self._make_arrival(request, i)
            )
        return True

    def _make_arrival(self, request: Request, index: int):
        def _arrive() -> None:
            f = Frame(
                request_id=request.request_id,
                category=request.category,
                index=index,
                arrival_time=self.loop.now,
                deadline=self.loop.now + request.relative_deadline,
            )
            heapq.heappush(self._queue, (f.deadline, self._seq, f))
            self._seq += 1
            self._maybe_start()
        return _arrive

    def _maybe_start(self) -> None:
        if not self.device.idle or not self._queue:
            return
        _, _, f = heapq.heappop(self._queue)
        wcet = self.table.wcet(f.category.model_id, f.category.shape_key, 1)
        actual = self.actual_fn(f, wcet)
        self.device.submit(f, actual, self._on_complete)

    def _on_complete(self, frame: Frame, now: float) -> None:
        frame.completion_time = now
        self.metrics.record_job(1)
        self.metrics.record_frame(frame)

    def run(self, until: Optional[float] = None) -> Metrics:
        self.loop.run(until)
        return self.metrics
