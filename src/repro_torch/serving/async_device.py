"""AsyncDevice: the live-serving side of the shared device contract.

``SequentialDevice`` (core/simulator.py) models a one-program-at-a-time
accelerator in virtual time: ``submit`` returns immediately and the
completion fires as a future loop event, so host-side scheduling overlaps
device execution. This class gives the LIVE wall-clock path the exact
same shape:

- ``submit`` launches the job onto the CUDA stream (``dispatch_fn``
  returns a ``StepHandle`` without blocking) and returns to the event
  loop immediately — DisBatcher window joints, admission tests, and
  adaptation all run while the device executes;
- a single lightweight waiter thread blocks on ``handle.wait()`` (a
  CUDA event's ``synchronize`` underneath) and posts the completion back onto
  the loop thread via ``WallClock.post`` — callbacks never run off-loop;
- ``busy_until`` is the profiled *estimate* (the submit-time
  ``exec_time``), which is what the admission snapshot reads; the actual
  completion instant is whatever the hardware delivers.

Health hooks: when a ``watchdog`` (core/faults.CompletionWatchdog) is
attached, every job arms a completion deadline on the loop thread and
every completion disarms it — a hung ``StepHandle.wait`` therefore
becomes a *visible* overdue signal instead of a silent wedge.  When
``on_measured`` is set, each completion reports ``(expected, actual)``
seconds to it, which is what feeds live WCET re-profiling.

The clock of both starts when the device reaches the job. With a
``mark_fn`` (the engine's ``stream_mark``: a CUDA event recorded on the
stream ahead of the job's launches) the waiter watches that mark while
the loop's thread enqueues the job, reads the instant it completes (both
clocks start there) and posts the start to the loop: slices that share one CUDA
stream queue behind each other's work, and that wait is not time the
device spent on this job (a reference slice is its own device and never
waits so). A job the stream never reaches is still caught: the job at
the head of the stream has begun, and its own slice's clock runs.
Without a mark (the CPU, where ``mark_fn`` returns None) the clock
starts at submit.

The EDF worker's submit-only-when-idle discipline is unchanged, so the
non-preemptive EDF semantics (and the Phase-2 imitator's model of them)
are identical to simulation — the only difference is that the loop no
longer stalls for the duration of each job.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from repro_torch.core import telemetry as T


class _Inflight:
    """One submitted job travelling from the loop to the waiter and back."""

    __slots__ = ("job", "handle", "on_complete", "job_bytes", "start", "exec_time", "began",
                 "released", "dispatched")

    def __init__(self, job, handle, on_complete, job_bytes, start, exec_time, began=None):
        self.job = job
        self.handle = handle  # None until the job is enqueued (or if that raised)
        # Set once ``submit`` is done with the job, whether its dispatch
        # returned a handle or raised.
        self.dispatched = threading.Event()
        self.on_complete = on_complete
        self.job_bytes = job_bytes
        self.start = start  # the clock's start: submit, then the mark's instant
        self.exec_time = exec_time
        self.began = began  # the stream mark ahead of the job's launches, or None
        self.released = False


class AsyncDevice:
    """Wall-clock sequential device with non-blocking dispatch.

    Parameters
    ----------
    loop:
        A ``WallClock`` (needs ``post``/``hold``/``release``).
    dispatch_fn:
        job -> handle. Must launch the job without blocking and return a
        handle whose ``wait()`` blocks until device completion (see
        ``serving.engine.StepHandle``).
    mark_fn:
        () -> an event with ``synchronize()`` recorded on the device's
        stream, or None; called just before ``dispatch_fn``. The job's
        watchdog and measured clocks start once it completes.
    """

    #: Seconds ``close()`` waits for the waiter thread before declaring
    #: it wedged and abandoning it (a hung ``StepHandle.wait`` never
    #: returns; shutdown must not inherit the hang).
    JOIN_TIMEOUT = 0.5

    def __init__(
        self,
        loop,
        dispatch_fn: Callable[[object], object],
        on_idle: Optional[Callable[[], None]] = None,
        join_timeout: Optional[float] = None,
        mark_fn: Optional[Callable[[], object]] = None,
    ):
        self.loop = loop
        self.dispatch_fn = dispatch_fn
        self.mark_fn = mark_fn
        self.on_idle = on_idle
        self.join_timeout = self.JOIN_TIMEOUT if join_timeout is None else join_timeout
        self._busy_until: Optional[float] = None
        self._closed = False
        self.wedged = False  # close() timed out joining a stuck waiter
        self.last_error: Optional[Exception] = None
        self.busy_time = 0.0  # total measured seconds executing
        self.resident_bytes = 0.0
        self.peak_bytes = 0.0
        # Health hooks (both optional; attached by the live cluster
        # factory). ``watchdog.started/completed`` run on the loop
        # thread; ``on_measured(expected, actual)`` fires per completion.
        self.watchdog = None
        self.on_measured: Optional[Callable[[float, float], None]] = None
        # Frame-lifecycle tracer (core/telemetry.py); None = off. This
        # is the live-only expected-vs-measured lane — simulation has no
        # hardware clock to disagree with.
        self.tracer = None
        self.tracer_tag: Optional[str] = None
        self._lock = threading.Lock()
        self._inflight: Optional[_Inflight] = None
        self._inbox: "queue.Queue" = queue.Queue()
        self._waiter = threading.Thread(
            target=self._wait_loop, name="asyncdevice-waiter", daemon=True
        )
        self._waiter.start()

    @property
    def idle(self) -> bool:
        # A closed device (its slice failed) is never idle: the EDF
        # worker's submit-only-when-idle discipline then guarantees no
        # further dispatch without any scheduler-side special-casing —
        # the dead slice's queued jobs simply never start.
        return not self._closed and self._busy_until is None

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def busy_until(self) -> Optional[float]:
        return self._busy_until

    def submit(
        self,
        job: object,
        exec_time: float,
        on_complete: Callable[[object, float], None],
        job_bytes: float = 0.0,
    ) -> None:
        """Non-blocking: async-dispatch the job, hand the handle to the
        waiter, return to the loop. ``exec_time`` is the estimate used
        for ``busy_until`` only (contract: simulator.SequentialDevice)."""
        if self._closed:
            raise RuntimeError("AsyncDevice is closed (slice failed)")
        if not self.idle:
            raise RuntimeError("AsyncDevice is busy; EDF worker bug")
        start = self.loop.now
        self._busy_until = start + exec_time
        self.resident_bytes += job_bytes
        self.peak_bytes = max(self.peak_bytes, self.resident_bytes)
        began = self.mark_fn() if self.mark_fn is not None else None
        item = _Inflight(job, None, on_complete, job_bytes, start, exec_time, began)
        # The waiter watches the mark while this thread enqueues the job:
        # the stream reaches a host-bound eager step long before its
        # enqueue ends, and the job's clock starts there.
        self._inbox.put(item)
        try:
            handle = self.dispatch_fn(job)  # returns immediately (stream-ordered)
        except BaseException:
            item.dispatched.set()  # no handle: the waiter drops the job
            raise
        if self.watchdog is not None and began is None:
            self.watchdog.started(job, exec_time)
        self.loop.hold()  # keep run() alive while the heap may be empty
        item.handle = handle
        with self._lock:
            self._inflight = item
        item.dispatched.set()

    # ----- waiter thread --------------------------------------------------
    def _wait_loop(self) -> None:
        while True:
            item = self._inbox.get()
            if item is None:
                return
            err = None
            reached = None
            if item.began is not None:
                try:
                    item.began.synchronize()  # the stream has reached the job
                    reached = self.loop.now
                except Exception as e:  # re-raised on the loop thread
                    err = self.last_error = e
            item.dispatched.wait()
            if item.handle is None:
                continue  # its dispatch raised on the loop's thread
            if reached is not None:
                self.loop.post(
                    lambda it=item, t=reached: self._begin(it, t),
                    priority=getattr(self.loop, "PRIO_COMPLETE", 1),
                )
            if err is None:
                try:
                    item.handle.wait()
                except Exception as e:  # re-raised on the loop thread
                    err = self.last_error = e
            self.loop.post(
                lambda it=item, x=err: self._complete(it, x),
                priority=getattr(self.loop, "PRIO_COMPLETE", 1),
            )
            self._release_once(item)

    def _release_once(self, item: _Inflight) -> None:
        """Release the loop hold for ``item`` exactly once — called by the
        waiter on completion AND by ``close()`` when it abandons a wedged
        waiter; whichever runs second is a no-op, so ``WallClock``'s
        hold/release pairing survives the race."""
        with self._lock:
            if item.released:
                return
            item.released = True
            if self._inflight is item:
                self._inflight = None
        self.loop.release()

    # ----- loop-thread begin and completion ------------------------------
    def _begin(self, item: _Inflight, reached: float) -> None:
        """The stream reached ``item`` at ``reached`` (read by the waiter
        as the mark completed): the measured and the watchdog's clocks
        start there, not when the loop's thread gets to this post (it may
        still be enqueueing that very job, or another slice's). Posted
        before the job's completion by the same waiter, at the same
        priority, so it always runs first."""
        item.start = reached
        if self.watchdog is not None:
            self.watchdog.started(item.job, item.exec_time, start=reached)

    def _complete(self, item: _Inflight, err: Optional[Exception] = None) -> None:
        now = self.loop.now
        actual = now - item.start
        self.busy_time += actual
        self._busy_until = None
        self.resident_bytes -= item.job_bytes
        if self.watchdog is not None:
            self.watchdog.completed()
        if self.tracer is not None:
            self.tracer.emit(
                T.DEVICE_MEASURED, now, where=self.tracer_tag,
                meta={"expected": item.exec_time, "actual": actual})
        if self._closed:
            # The slice died while this job was in flight: its frames are
            # lost with the slice (the cluster re-admits the request's
            # remaining tail elsewhere). Reporting the completion would
            # count dead frames as served and re-enter EDF dispatch on a
            # device that can no longer execute.
            return
        if err is not None:
            # A failed execution must NOT be reported as a completed job
            # (frames would count as deadline-met with no output). Device
            # state is released, then the failure propagates out of
            # loop.run() to the caller.
            raise RuntimeError(f"device execution failed for {item.job!r}") from err
        if self.on_measured is not None:
            self.on_measured(item.exec_time, actual)
            if self._closed:
                # This very measurement was the late signal that
                # quarantined the slice (note_complete -> fail_slice ->
                # close): the job's frames are already reconciled as
                # lost — reporting the completion would double-count.
                return
        item.on_complete(item.job, now)
        if self.on_idle is not None:
            self.on_idle()

    def close(self) -> None:
        """Fail-stop the device (idempotent): refuse new submissions,
        report not-idle forever, swallow the in-flight completion if any,
        and join the waiter thread with a timeout. If an in-flight step
        is wedged inside ``StepHandle.wait`` the join times out, the
        device marks itself ``wedged``, abandons the daemon waiter with
        its hung handle, and releases the in-flight hold on the loop so
        ``run()`` can terminate — shutdown never inherits the hang. The
        live cluster's ``fail_slice`` calls this before re-admitting the
        slice's requests elsewhere."""
        if self._closed:
            return
        self._closed = True
        if self.watchdog is not None:
            self.watchdog.close()
        self._inbox.put(None)
        self._waiter.join(timeout=self.join_timeout)
        if self._waiter.is_alive():
            self.wedged = True
            with self._lock:
                item = self._inflight
            if item is not None:
                self._release_once(item)
