"""Fault injection and completion watchdog for the shared device contract.

Real edge accelerators throttle, stall, and die mid-step; the paper's
Adaptation Module (§4.4) only reacts *after* a job completes late, so a
hung step is invisible to it forever.  This module supplies both halves
of the fix:

- :class:`FaultyDevice` wraps either device-contract implementation
  (``SequentialDevice`` in virtual time, ``AsyncDevice`` live) and
  injects deterministic, seed-driven faults — completion delay
  (throttling), indefinite stall (hang), transient submit error, and
  permanent death — so failure paths are testable and replayable.
- :class:`CompletionWatchdog` arms a per-submit completion deadline
  (expected WCET × slack, floored by ``min_deadline``) plus a heartbeat
  while a submit is overdue.  It uses only ``loop.schedule / cancel /
  now``, so the *same* code runs under ``EventLoop`` virtual time and
  the live ``WallClock``.

The watchdog reports to a policy callback (the cluster's
``SliceHealthMonitor``); it never decides anything itself.
"""
from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import telemetry as T


class TransientSubmitError(RuntimeError):
    """A submit that failed without damaging the device; safe to retry."""


class DeviceDeadError(RuntimeError):
    """Submit on a device that has permanently died."""


# Fault kinds.
DELAY = "delay"            # completion lands late (throttled accelerator)
STALL = "stall"            # completion never lands (hung step)
SUBMIT_ERROR = "submit_error"  # submit raises TransientSubmitError once
DEATH = "death"            # current submit stalls AND all future submits die
# Network-shaped completion faults: the device finishes on time but its
# completion SIGNAL misbehaves (a retried RPC ack lands twice; an ack is
# held in a queue and arrives after later jobs' acks).
DUP_COMPLETE = "dup_complete"        # completion callback fires twice
REORDER_COMPLETE = "reorder_complete"  # completion callback arrives late,
                                       # possibly after later jobs' callbacks

FAULT_KINDS = (DELAY, STALL, SUBMIT_ERROR, DEATH, DUP_COMPLETE, REORDER_COMPLETE)


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault, keyed by the device's submit index.

    ``factor``/``extra`` apply to DELAY only: the completion lands at
    ``max(expected * factor, expected + extra)`` after the submit, which
    lets tests express both relative throttling (factor) and absolute
    lateness large enough to cross a watchdog's ``min_deadline`` floor
    (extra) regardless of how small the profiled WCET is.
    """

    kind: str
    at_submit: int
    factor: float = 3.0
    extra: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.at_submit < 0:
            raise ValueError("at_submit must be >= 0")
        if self.kind == DELAY and self.factor < 1.0 and self.extra <= 0.0:
            raise ValueError("a DELAY fault must actually delay (factor >= 1 or extra > 0)")
        if self.kind == REORDER_COMPLETE and self.factor <= 1.0 and self.extra <= 0.0:
            raise ValueError(
                "a REORDER_COMPLETE fault must defer the signal "
                "(factor > 1 or extra > 0)"
            )


class FaultPlan:
    """A deterministic fault schedule: at most one fault per submit index."""

    def __init__(self, specs: Tuple[FaultSpec, ...] = ()) -> None:
        self.by_submit: Dict[int, FaultSpec] = {}
        for spec in specs:
            if spec.at_submit in self.by_submit:
                raise ValueError(f"duplicate fault at submit index {spec.at_submit}")
            self.by_submit[spec.at_submit] = spec

    @property
    def specs(self) -> List[FaultSpec]:
        return [self.by_submit[i] for i in sorted(self.by_submit)]

    def for_submit(self, index: int) -> Optional[FaultSpec]:
        return self.by_submit.get(index)

    def __len__(self) -> int:
        return len(self.by_submit)

    @classmethod
    def from_seed(
        cls,
        seed: int,
        n_submits: int,
        p_delay: float = 0.0,
        p_stall: float = 0.0,
        p_error: float = 0.0,
        p_death: float = 0.0,
        p_dup_complete: float = 0.0,
        p_reorder_complete: float = 0.0,
        delay_factor: Tuple[float, float] = (2.0, 6.0),
        delay_extra: Tuple[float, float] = (0.0, 0.0),
    ) -> "FaultPlan":
        """Draw an independent fault (or none) for each submit index.

        Same seed and parameters -> identical plan, so any failure found
        under a random plan is replayable from its seed alone.  The
        per-index draw count is branch-independent, so plans with the
        same seed agree on their common prefix regardless of length.
        """
        total = p_delay + p_stall + p_error + p_death
        total += p_dup_complete + p_reorder_complete
        if total > 1.0:
            raise ValueError("fault probabilities must sum to <= 1")
        rng = random.Random(seed)
        specs = []
        for i in range(n_submits):
            r = rng.random()
            factor = rng.uniform(*delay_factor)
            extra = rng.uniform(*delay_extra)
            if r < p_delay:
                specs.append(FaultSpec(DELAY, i, factor=factor, extra=extra))
            elif r < p_delay + p_stall:
                specs.append(FaultSpec(STALL, i))
            elif r < p_delay + p_stall + p_error:
                specs.append(FaultSpec(SUBMIT_ERROR, i))
            elif r < p_delay + p_stall + p_error + p_death:
                specs.append(FaultSpec(DEATH, i))
            elif r < p_delay + p_stall + p_error + p_death + p_dup_complete:
                specs.append(FaultSpec(DUP_COMPLETE, i))
            elif r < total:
                specs.append(
                    FaultSpec(REORDER_COMPLETE, i,
                              factor=max(factor, 1.0 + 1e-9), extra=extra)
                )
        return cls(tuple(specs))


@dataclass(frozen=True)
class WatchdogConfig:
    """Knobs for per-submit completion deadlines and slice health policy.

    A submit's completion deadline is ``max(expected * slack,
    min_deadline)``; a completion later than that is a *late signal*, as
    is every heartbeat that fires while the submit is still outstanding.
    A submit outstanding past ``hang_slack / slack`` times its deadline
    is declared *hung* (immediate quarantine — a hang can never produce
    a late completion to count).  ``min_deadline`` floors the deadline
    in wall-clock terms so millisecond-scale WCETs on a busy CI host do
    not false-positive on scheduler jitter.
    """

    slack: float = 4.0
    hang_slack: float = 12.0
    heartbeat: Optional[float] = None  # None: re-check every deadline interval
    min_deadline: float = 0.0
    suspect_after: int = 2      # consecutive late signals: healthy -> suspect
    quarantine_after: int = 6   # consecutive late signals: suspect -> quarantined
    recover_after: int = 3      # consecutive clean completions: suspect -> healthy
    sample_window: int = 64     # (expected, actual) samples retained per slice
    reprofile_samples: int = 8  # recent samples consulted on suspect entry
    reprofile_quantile: float = 0.9

    def __post_init__(self) -> None:
        if self.slack <= 1.0:
            raise ValueError("slack must be > 1 (a deadline at the WCET itself is all-late)")
        if self.hang_slack <= self.slack:
            raise ValueError("hang_slack must exceed slack")
        for name in ("suspect_after", "quarantine_after", "recover_after"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if not 0.0 < self.reprofile_quantile <= 1.0:
            raise ValueError("reprofile_quantile must be in (0, 1]")

    def deadline_for(self, expected: float) -> float:
        return max(expected * self.slack, self.min_deadline)

    def hang_after(self, expected: float) -> float:
        return self.deadline_for(expected) * (self.hang_slack / self.slack)


class CompletionWatchdog:
    """Per-device completion deadline + heartbeat, loop-generic.

    The owning device calls :meth:`started` on submit and
    :meth:`completed` when the completion lands (both on the loop
    thread).  While a submit is outstanding past its deadline,
    ``on_overdue(job, expected, elapsed)`` fires on every heartbeat
    until the job completes or the watchdog is closed (quarantining a
    slice closes its device, which closes the watchdog).
    """

    def __init__(self, loop, config: WatchdogConfig, on_overdue: Callable) -> None:
        self.loop = loop
        self.config = config
        self.on_overdue = on_overdue
        self.overdue_events = 0
        # Frame-lifecycle tracer (core/telemetry.py) for standalone
        # (non-cluster) watchdogs; the cluster lane emits via its
        # SliceHealthMonitor instead, which knows the slice name.
        self.tracer = None
        self.tracer_tag: Optional[str] = None
        self._token = 0
        self._outstanding: Optional[Tuple[int, object, float, float]] = None
        self._eid = None
        self._closed = False

    def started(self, job, expected: float) -> None:
        if self._closed:
            return
        if self._outstanding is not None:
            raise RuntimeError(
                "CompletionWatchdog: overlapping submits on a sequential device"
            )
        self._token += 1
        start = self.loop.now
        self._outstanding = (self._token, job, expected, start)
        self._arm(self._token, start + self.config.deadline_for(expected))

    def completed(self) -> None:
        self._outstanding = None
        if self._eid is not None:
            self.loop.cancel(self._eid)
            self._eid = None

    def close(self) -> None:
        self._closed = True
        self.completed()

    def _arm(self, token: int, when: float) -> None:
        self._eid = self.loop.schedule(
            max(when, self.loop.now),
            lambda: self._check(token),
            priority=getattr(self.loop, "PRIO_COMPLETE", 0),
        )

    def _check(self, token: int) -> None:
        self._eid = None
        out = self._outstanding
        if self._closed or out is None or out[0] != token:
            return
        _, job, expected, start = out
        elapsed = self.loop.now - start
        self.overdue_events += 1
        if self.tracer is not None:
            self.tracer.emit(
                T.WATCHDOG_OVERDUE, self.loop.now, where=self.tracer_tag,
                meta={"expected": expected, "elapsed": elapsed})
        self.on_overdue(job, expected, elapsed)
        # The overdue handler may have quarantined the slice (closing us)
        # by the time it returns; never re-arm in that case.
        if self._closed or self._outstanding is None or self._outstanding[0] != token:
            return
        beat = self.config.heartbeat
        if beat is None:
            beat = self.config.deadline_for(expected)
        self._arm(token, self.loop.now + beat)


class _WedgedHandle:
    """A dispatch handle whose ``wait()`` blocks until released.

    Handed to ``AsyncDevice``'s dispatch path on an injected STALL/DEATH:
    the waiter thread wedges inside ``wait()`` exactly as it would on a
    hung ``block_until_ready``, which is what the close-with-timeout
    path and the watchdog must survive.
    """

    def __init__(self, release: threading.Event) -> None:
        self._release = release

    def wait(self):
        self._release.wait()
        return None


class _ThrottledHandle:
    """Delays an underlying handle's completion to a fixed instant."""

    def __init__(self, inner, clock: Callable[[], float], until: float) -> None:
        self._inner = inner
        self._clock = clock
        self._until = until

    def wait(self):
        result = self._inner.wait() if self._inner is not None else None
        remaining = self._until - self._clock()
        if remaining > 0:
            time.sleep(remaining)
        return result


class FaultyDevice:
    """Deterministic fault injection behind the shared device contract.

    Wraps either contract implementation:

    - live ``AsyncDevice`` (detected by its ``dispatch_fn`` attribute):
      DELAY/STALL/DEATH inject at the dispatch-handle layer, so the
      inner device's waiter thread, watchdog, and hold/release
      accounting see exactly what a throttled or hung accelerator does;
    - simulated ``SequentialDevice``: DELAY inflates the completion
      event, STALL/DEATH never schedule one.  The optional ``watchdog``
      and ``on_measured`` hooks mirror what ``AsyncDevice`` provides
      natively, so the health machinery runs identically in sim.

    DEATH stalls the current submit and additionally marks the device
    dead: every later submit raises :class:`DeviceDeadError` and
    ``idle`` stays False, so an EDF worker can never dispatch to it
    again.  The device is *not* closed — detection is the watchdog's
    job, exactly as for a real dying accelerator.
    """

    def __init__(
        self,
        inner,
        plan: FaultPlan,
        watchdog: Optional[CompletionWatchdog] = None,
        on_measured: Optional[Callable[[float, float], None]] = None,
        on_submit_error: Optional[Callable[[], None]] = None,
    ) -> None:
        self.inner = inner
        self.plan = plan
        self.loop = inner.loop
        self.watchdog = watchdog
        self.on_measured = on_measured
        self.on_submit_error = on_submit_error
        self.is_live = hasattr(inner, "dispatch_fn")
        self.submits = 0
        self.injected: List[Tuple[int, str, float]] = []  # (index, kind, t)
        self._dead = False
        self._stalled = False
        self._stall_until: Optional[float] = None
        self._wedge = threading.Event()  # released on close: wedged waiters drain

    # ------------------------------------------------------------------
    # Device contract
    # ------------------------------------------------------------------
    @property
    def idle(self) -> bool:
        if self._dead or self._stalled:
            return False
        return self.inner.idle

    @property
    def busy_until(self) -> Optional[float]:
        if self._stalled:
            return self._stall_until
        return self.inner.busy_until

    @property
    def closed(self) -> bool:
        return self.inner.closed

    @property
    def on_idle(self):
        return self.inner.on_idle

    @on_idle.setter
    def on_idle(self, fn) -> None:
        # DeepRT assigns device.on_idle after construction; a plain
        # attribute set here would shadow the inner device's callback.
        self.inner.on_idle = fn

    def submit(self, job, exec_time: float, on_complete, job_bytes: float = 0.0) -> None:
        if self._dead:
            raise DeviceDeadError(f"device died at submit {self._death_index()}; cannot run {job!r}")
        index = self.submits
        self.submits += 1
        spec = self.plan.for_submit(index)
        if spec is None:
            self._submit_clean(job, exec_time, on_complete, job_bytes)
            return
        self.injected.append((index, spec.kind, self.loop.now))
        if spec.kind == DUP_COMPLETE:
            self._submit_clean(job, exec_time, self._duplicated(on_complete), job_bytes)
            return
        if spec.kind == REORDER_COMPLETE:
            defer = max(exec_time * (spec.factor - 1.0), spec.extra)
            self._submit_clean(job, exec_time, self._deferred(on_complete, defer), job_bytes)
            return
        if spec.kind == SUBMIT_ERROR:
            if self.on_submit_error is not None:
                self.on_submit_error()
            raise TransientSubmitError(f"injected submit fault at index {index}")
        if spec.kind == DEATH:
            self._dead = True
        if spec.kind in (STALL, DEATH):
            self._begin_stall(job, exec_time, on_complete, job_bytes)
            return
        self._submit_delayed(job, exec_time, on_complete, job_bytes, spec)

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.close()
        self.inner.close()
        # Drain any waiter wedged on an injected stall into the (now
        # closed) inner device, where its completion is swallowed.
        self._wedge.set()

    def __getattr__(self, name):
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # ------------------------------------------------------------------
    # Injection mechanics
    # ------------------------------------------------------------------
    def _death_index(self) -> int:
        for index, kind, _t in self.injected:
            if kind == DEATH:
                return index
        return -1

    def _duplicated(self, on_complete):
        """DUP_COMPLETE: the signal lands twice — once on time, once
        again immediately after (a retried ack).  The device itself runs
        the job once; only the callback repeats, so the consumer's
        idempotency (EDF's completed-job guard) is what is under test."""
        def wrapped(job, t) -> None:
            on_complete(job, t)
            def again() -> None:
                if not self.closed:
                    on_complete(job, t)
            self.loop.schedule(
                self.loop.now, again,
                priority=getattr(self.loop, "PRIO_COMPLETE", 0),
            )
        return wrapped

    def _deferred(self, on_complete, defer: float):
        """REORDER_COMPLETE: the device frees on time (later jobs run and
        complete), but THIS job's completion signal is held for ``defer``
        seconds — it can arrive after later jobs' signals."""
        def wrapped(job, t) -> None:
            def late() -> None:
                if not self.closed:
                    on_complete(job, t)
            self.loop.schedule(
                self.loop.now + defer, late,
                priority=getattr(self.loop, "PRIO_COMPLETE", 0),
            )
        return wrapped

    def _submit_clean(self, job, exec_time, on_complete, job_bytes) -> None:
        if self.is_live:
            self.inner.submit(job, exec_time, on_complete, job_bytes=job_bytes)
            return
        self._sim_submit(job, exec_time, exec_time, on_complete, job_bytes)

    def _submit_delayed(self, job, exec_time, on_complete, job_bytes, spec: FaultSpec) -> None:
        effective = max(exec_time * spec.factor, exec_time + spec.extra)
        if self.is_live:
            inner_dispatch = self.inner.dispatch_fn
            until = self.loop.now + effective
            self.inner.dispatch_fn = lambda j: _ThrottledHandle(
                inner_dispatch(j), lambda: self.loop.now, until
            )
            try:
                self.inner.submit(job, exec_time, on_complete, job_bytes=job_bytes)
            finally:
                self.inner.dispatch_fn = inner_dispatch
            return
        self._sim_submit(job, exec_time, effective, on_complete, job_bytes)

    def _begin_stall(self, job, exec_time, on_complete, job_bytes) -> None:
        if self.is_live:
            # Wedge the real waiter thread: this submit's handle never
            # resolves, the inner device's hold on the loop stays up
            # until close() releases it, and the inner watchdog sees a
            # genuinely missing completion.
            inner_dispatch = self.inner.dispatch_fn
            self.inner.dispatch_fn = lambda j: _WedgedHandle(self._wedge)
            try:
                self.inner.submit(job, exec_time, on_complete, job_bytes=job_bytes)
            finally:
                self.inner.dispatch_fn = inner_dispatch
            return
        # Sim: the device goes busy forever without touching the inner
        # device; only the watchdog can notice.
        self._stalled = True
        self._stall_until = math.inf
        if self.watchdog is not None:
            self.watchdog.started(job, exec_time)

    def _sim_submit(self, job, expected, effective, on_complete, job_bytes) -> None:
        if self.watchdog is not None:
            self.watchdog.started(job, expected)
        start = self.loop.now

        def _measured(j, t) -> None:
            if self.watchdog is not None:
                self.watchdog.completed()
            if self.on_measured is not None:
                self.on_measured(expected, t - start)
            if self.closed:
                # This very measurement was the late signal that
                # quarantined the slice: fail_slice already reconciled
                # the job's frames as lost — reporting the completion
                # now would double-count them.
                return
            on_complete(j, t)

        self.inner.submit(job, effective, _measured, job_bytes=job_bytes)
