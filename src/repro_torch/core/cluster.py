"""Cluster scheduler: DeepRT at pod scale (beyond-paper layer).

The paper schedules one GPU. At pod scale a deployment runs many *slices*
(a pod, or a sub-mesh hosting one model's SPMD program). Each slice runs
its own DeepRT instance (DisBatcher + EDF + admission) — the paper's
design is per-accelerator, so it shards naturally. This layer adds what a
1000-node deployment needs on top:

- placement: route a new request to the slice with the lowest Phase-1
  utilization that can host its category (capability = profiled model)
  AND has a free decode-arena row for it; admission on the chosen slice
  decides finally (spill to the next candidate on rejection);
- fault tolerance: on slice failure every in-flight request of that slice
  is *re-admitted* elsewhere — the paper's admission test doubles as the
  recovery policy, so recovery never overloads surviving slices;
- degraded capacity / stragglers: a slice may be marked slow with factor f;
  its WCET table is scaled by f (ProfileTable.scaled) and its *future*
  admissions see the degraded table, while the overrun/adaptation machinery
  (paper §4.4) absorbs the transient — the paper's penalty mechanism is
  precisely straggler mitigation at this level;
- elastic scale-up: adding a slice makes its capacity available to the
  placement loop immediately.

Two slice flavors behind one interface:

- ``Slice``: simulation — its DeepRT runs on the cluster's (virtual)
  event loop against a ``SequentialDevice`` with sampled exec times.
- ``LiveSlice``: real serving — its DeepRT owns a compiled
  ``InferenceEngine`` (per-slice resident KV arena, per-slice
  ``max_slots`` from ``bucketing.slice_arena_slots`` under the slice's
  Phase-1 utilization bound), an ``AsyncDevice``, and a per-slice
  profiled WCET table, all behind the shared device contract
  (ROADMAP architecture note). Decode requests LEASE an arena row on
  their slice at admission and release it when their last frame
  completes; ``fail_slice`` fail-stops the slice (device closed, engine
  frozen — its arena rows are never touched again) and re-admits the
  in-flight tails onto surviving slices' arenas by re-leasing rows
  there, never by re-creating arenas. ``serving.batcher_bridge.
  build_live_cluster`` is the factory.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import telemetry as T
from repro_torch.core.faults import (
    CompletionWatchdog,
    FaultPlan,
    FaultyDevice,
    WatchdogConfig,
)
from repro_torch.core.profiler import ProfileTable
from repro_torch.core.request import Request
from repro_torch.core.scheduler import DeepRT, ExecutionModel
from repro_torch.core.simulator import EventLoop, SequentialDevice
from repro_torch.core.telemetry import LatencyHistogram, render_text

# Slice health states (the watchdog-driven state machine):
#
#   HEALTHY --(suspect_after consecutive late signals)--> SUSPECT
#   SUSPECT --(recover_after consecutive clean completions)--> HEALTHY
#   SUSPECT --(quarantine_after consecutive late signals)--> QUARANTINED
#   any     --(hung submit / operator fail_slice)--> QUARANTINED
#
# SUSPECT slices stay alive and keep serving what they already host but
# receive NO new placements; entering and leaving SUSPECT both trigger
# live re-profiling (the WCET table is rescaled from measured
# completions). QUARANTINED is terminal: the slice is fail-stopped
# (``fail_slice``) and its tails re-admitted elsewhere.
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"


@dataclass
class SliceSpec:
    name: str
    table: ProfileTable  # per-slice WCET table (mesh-dependent)
    models: Optional[Sequence[str]] = None  # None = hosts any profiled model
    # Phase-1 utilization ceiling this slice's admission enforces; the
    # live factory also sizes the slice's decode arena from it
    # (``bucketing.slice_arena_slots``).
    utilization_bound: float = 1.0


class Slice:
    def __init__(self, spec: SliceSpec, loop: EventLoop, execution=None,
                 adaptation_enabled: bool = True, scheduler: Optional[DeepRT] = None):
        """``scheduler=None`` (simulation) builds a DeepRT on the shared
        loop; ``LiveSlice`` passes a pre-wired live scheduler instead."""
        self.spec = spec
        if scheduler is None:
            scheduler = DeepRT(
                spec.table, loop=loop, execution=execution,
                adaptation_enabled=adaptation_enabled,
                utilization_bound=spec.utilization_bound,
            )
        self.scheduler = scheduler
        self.alive = True
        self.health = HEALTHY
        self.slow_factor = 1.0
        # Lease ledger — request_id -> token from ``_alloc``. The base
        # (simulation) slice tracks SYMBOLIC leases so lifecycle
        # invariants ("every terminal path releases its lease") are
        # checkable without live arenas; LiveSlice's ``_alloc``/``_free``
        # back the same ledger with real arena rows.
        self.leases: Dict[int, object] = {}
        self._frames_left: Dict[int, int] = {}
        # Release rows when a request's last frame completes, without
        # stealing the adaptation module's completion hook.
        prev = self.scheduler.worker.on_job_complete

        def _chained(job, actual, _prev=prev):
            if _prev is not None:
                _prev(job, actual)
            self._on_job_complete(job)

        self.scheduler.worker.on_job_complete = _chained

    def hosts(self, request: Request) -> bool:
        if not self.alive:
            return False
        if self.spec.models is not None and request.category.model_id not in self.spec.models:
            return False
        return self.spec.table.has(
            request.category.model_id, request.category.shape_key
        )

    def utilization(self) -> float:
        return self.scheduler.utilization()

    # -- capacity leases ---------------------------------------------------
    def can_lease(self, request: Request) -> bool:
        return True

    def _alloc(self, request: Request):
        """Resource hook: return the token recorded in ``leases`` (None
        = this request needs no resident resource). The sim token is
        symbolic — no backing resource, only the ledger entry."""
        return ("sim", request.category.model_id)

    def _free(self, token) -> None:
        pass

    def lease(self, request: Request) -> None:
        token = self._alloc(request)
        if token is None:
            return
        self.leases[request.request_id] = token
        self._frames_left[request.request_id] = request.n_frames

    def release(self, request_id: int) -> None:
        token = self.leases.pop(request_id, None)
        self._frames_left.pop(request_id, None)
        if token is None:
            return
        if not self.alive:
            # Dead slice: its resources must never be touched again —
            # the lease record is dropped, the backing rows stay as the
            # failure left them.
            return
        self._free(token)

    def _count_frame_done(self, rid: int) -> None:
        """One of ``rid``'s frames will never need the leased resource
        again (completed OR shed upstream); release on the last."""
        left = self._frames_left.get(rid)
        if left is None:
            return
        if left <= 1:
            self.release(rid)
        else:
            self._frames_left[rid] = left - 1

    def note_dropped(self, request_id: int) -> None:
        """Gateway shed one frame of this request: one fewer completion
        will ever arrive, so the lease frame-countdown must advance."""
        self._count_frame_done(request_id)

    def _on_job_complete(self, job) -> None:
        for frame in job.frames:
            self._count_frame_done(frame.request_id)

    def shutdown(self) -> None:
        """Fail-stop: stop hosting new requests and close the device
        (both contract implementations swallow any in-flight completion
        and report not-idle forever, so the dead scheduler's queued jobs
        never start — simulation and live fail identically). LiveSlice
        extends this to freeze its engine. The lease ledger clears —
        nothing can release through a dead slice, and ``fail_slice``
        reconciles the frames those leases were counting."""
        self.alive = False
        self.scheduler.device.close()
        self.leases.clear()
        self._frames_left.clear()


class LiveSlice(Slice):
    """A slice whose DeepRT executes real compiled programs.

    Owns the full live stack: ``engine`` (this slice's resident KV
    arenas + compiled steps), ``device`` (its AsyncDevice), and — via
    ``spec.table`` — its own profiled WCET table. ``kinds`` maps
    (model_id, shape_key) -> "prefill" | "decode" (the bridge's category
    list), so the slice knows which requests are decode streams that
    occupy an arena row for their lifetime.
    """

    def __init__(self, spec: SliceSpec, scheduler: DeepRT, engine,
                 kinds: Dict[Tuple[str, Tuple[int, ...]], str],
                 leases: Optional[Dict[int, Tuple[str, int, Tuple[int, ...]]]] = None):
        super().__init__(spec, loop=scheduler.loop, scheduler=scheduler)
        self.engine = engine
        # The slice's AsyncDevice IS the scheduler's device — derived,
        # not a second parameter, so shutdown can never close one object
        # while metrics readers watch another.
        self.device = scheduler.device
        self.kinds = dict(kinds)
        # request_id -> (model_id, seq, arena row ids) for decode streams.
        # The live factory passes the SAME dict it gave the dispatch
        # closure, so slot-aligned payload staging always sees current
        # leases (shared by reference, one source of truth).
        if leases is not None:
            self.leases = leases

    def _decode_key(self, request: Request) -> Optional[Tuple[str, int]]:
        cat = request.category
        key = (cat.model_id, tuple(cat.shape_key))
        if self.kinds.get(key) != "decode":
            return None
        return cat.model_id, cat.shape_key[0]

    def can_lease(self, request: Request) -> bool:
        key = self._decode_key(request)
        if key is None:
            return True  # prefill / unknown: no resident row needed
        return len(self.engine.arena(*key).free) >= 1

    def _alloc(self, request: Request):
        """Pin one arena row for an admitted decode stream (one sequence
        = one resident KV row). Caller must have checked ``can_lease``;
        the allocator raises on exhaustion rather than reshaping."""
        key = self._decode_key(request)
        if key is None:
            return None  # prefill / unknown: no resident row needed
        mid, seq = key
        slots = self.engine.alloc_slots(mid, seq, 1)
        return (mid, seq, slots)

    def _free(self, token) -> None:
        mid, seq, slots = token
        self.engine.free_slots(mid, seq, slots)

    def shutdown(self) -> None:
        """Fail-stop the live stack: the device is closed by the base
        shutdown; the engine freezes so any later touch of this slice's
        arenas raises."""
        super().shutdown()
        self.engine.freeze()


@dataclass
class ParkedTail:
    """A displaced tail no surviving slice could accept at failover time.

    The tail keeps its ORIGINAL clock (``tail.start_time`` is fixed at
    the failover instant + one period), so the frames still deliverable
    shrink monotonically as real time passes and the entry provably
    expires once the last frame's arrival is behind us — re-basing the
    start on every retry would make a parked tail immortal.
    """

    origin_rid: int  # the displaced request this tail continues
    tail: Request
    parked_at: float
    attempts: int = 0
    # Transport-owned tails are re-admitted with external arrivals (the
    # rehome owner delivers the real bytes) instead of synthetic frames.
    external: bool = False


class SliceHealthMonitor:
    """Watchdog-signal sink + the healthy/suspect/quarantined policy.

    Devices report raw signals here (per-slice partials bound by the
    factories): ``note_overdue`` from each device's
    :class:`~repro.core.faults.CompletionWatchdog`, ``note_complete``
    with measured ``(expected, actual)`` seconds per completion, and
    ``note_submit_error`` on transient submit failures. The monitor
    turns sustained drift into state transitions, quarantines hung
    slices through the cluster's ``fail_slice``, and re-profiles WCET
    tables from measured completions on suspect entry and recovery.

    Subscribers (``subscribe(fn)``, ``fn(name, old, new)``) are notified
    on every transition BEFORE a quarantined slice is failed, so the
    ingest gateway can abort the slice's sessions (stop deliveries)
    ahead of the lost-frame reconciliation.
    """

    def __init__(self, cluster: "ClusterScheduler", config: Optional[WatchdogConfig] = None):
        self.cluster = cluster
        self.config = config if config is not None else WatchdogConfig()
        # name -> recent (expected, actual) completion samples.
        self.samples: Dict[str, Deque[Tuple[float, float]]] = {}
        self.late_streak: Dict[str, int] = {}
        self.clean_streak: Dict[str, int] = {}
        self.submit_errors: Dict[str, int] = {}
        self.reprofiles: Dict[str, int] = {}
        # Audit trail: (t, name, old, new, reason).
        self.transitions: List[Tuple[float, str, str, str, str]] = []
        self.listeners: List[Callable[[str, str, str], None]] = []
        # Frame-lifecycle tracer (core/telemetry.py); None = off.
        self.tracer = None

    def subscribe(self, fn: Callable[[str, str, str], None]) -> None:
        self.listeners.append(fn)

    def state(self, name: str) -> str:
        return self.cluster.slices[name].health

    # -- device-facing signal sinks ---------------------------------------
    def note_overdue(self, name: str, job, expected: float, elapsed: float) -> None:
        sl = self.cluster.slices.get(name)
        if sl is None or not sl.alive:
            return
        if self.tracer is not None:
            self.tracer.emit(
                T.WATCHDOG_OVERDUE, self.cluster.loop.now, where=name,
                meta={"expected": expected, "elapsed": elapsed})
        if elapsed >= self.config.hang_after(expected):
            # A hang can never produce the late *completions* the streak
            # counts — it is quarantined directly.
            self._quarantine(
                name,
                f"hung: no completion after {elapsed:.4f}s "
                f"(expected {expected:.4f}s)",
            )
            return
        self._late_signal(name, "overdue submit")

    def note_complete(self, name: str, expected: float, actual: float) -> None:
        sl = self.cluster.slices.get(name)
        if sl is None or not sl.alive:
            return
        dq = self.samples.setdefault(name, deque(maxlen=self.config.sample_window))
        dq.append((expected, actual))
        if actual > self.config.deadline_for(expected):
            self._late_signal(name, "late completion")
            return
        self.late_streak[name] = 0
        if sl.health == SUSPECT:
            self.clean_streak[name] = self.clean_streak.get(name, 0) + 1
            if self.clean_streak[name] >= self.config.recover_after:
                self._set_state(
                    name,
                    HEALTHY,
                    f"recovered: {self.config.recover_after} consecutive clean completions",
                )

    def note_submit_error(self, name: str) -> None:
        self.submit_errors[name] = self.submit_errors.get(name, 0) + 1
        sl = self.cluster.slices.get(name)
        if sl is None or not sl.alive:
            return
        self._late_signal(name, "transient submit error")

    # -- live re-profiling -------------------------------------------------
    def measured_drift(self, name: str, n_samples: Optional[int] = None) -> float:
        """Observed WCET drift: a high quantile of ``actual / expected``
        over the most recent completions, clamped to >= 1 (a table is
        never rescaled below its profiled base — underruns are normal)."""
        dq = self.samples.get(name)
        if not dq:
            raise RuntimeError(f"no measured completions recorded for slice {name!r}")
        n = n_samples if n_samples is not None else self.config.reprofile_samples
        recent = list(dq)[-n:]
        ratios = sorted(a / e for e, a in recent if e > 0)
        if not ratios:
            raise RuntimeError(f"no usable completion samples for slice {name!r}")
        idx = int(math.ceil(self.config.reprofile_quantile * len(ratios))) - 1
        return max(1.0, ratios[max(0, min(idx, len(ratios) - 1))])

    def reprofile(self, name: str, n_samples: Optional[int] = None) -> float:
        """Rescale the slice's WCET table from MEASURED completions.

        Replaces the operator-supplied stale scale of the old
        ``mark_slow``: admission on this slice now budgets what the
        hardware currently delivers, not what profiling once saw. Always
        rescales from the slice's base table, so repeated re-profiles
        never compound."""
        drift = self.measured_drift(name, n_samples)
        self.cluster._rescale(name, drift)
        self.reprofiles[name] = self.reprofiles.get(name, 0) + 1
        return drift

    # -- transitions -------------------------------------------------------
    def _late_signal(self, name: str, reason: str) -> None:
        self.clean_streak[name] = 0
        self.late_streak[name] = self.late_streak.get(name, 0) + 1
        streak = self.late_streak[name]
        health = self.cluster.slices[name].health
        if health == HEALTHY and streak >= self.config.suspect_after:
            self._set_state(name, SUSPECT, f"{reason}: {streak} consecutive late signals")
        elif health == SUSPECT and streak >= self.config.quarantine_after:
            self._quarantine(name, f"{reason}: drift persisted for {streak} late signals")

    def _quarantine(self, name: str, reason: str) -> None:
        self._set_state(name, QUARANTINED, reason)
        self.cluster.fail_slice(name)

    def _set_state(self, name: str, new: str, reason: str) -> None:
        sl = self.cluster.slices[name]
        old = sl.health
        if old == new:
            return
        sl.health = new
        self.late_streak[name] = 0
        self.clean_streak[name] = 0
        self.transitions.append((self.cluster.loop.now, name, old, new, reason))
        if self.tracer is not None:
            self.tracer.emit(
                T.HEALTH_TRANSITION, self.cluster.loop.now, where=name,
                meta={"old": old, "new": new, "reason": reason})
        # Couple into the paper's adaptation loop: a drifting device
        # tightens the gateway's shed budget for ALL its categories
        # (AdaptationModule.DEGRADED_BUDGET_TIGHTEN), not just penalized
        # ones.
        adaptation = getattr(sl.scheduler, "adaptation", None)
        if adaptation is not None:
            adaptation.note_device_health(new == HEALTHY)
        if new == SUSPECT:
            # Entering suspect: future admissions on this slice (none
            # while suspect, but its own running streams' re-placements)
            # must budget the drifted WCETs.
            try:
                self.reprofile(name)
            except RuntimeError:
                pass  # no completion samples yet (e.g. first submit hung)
        elif new == HEALTHY and old == SUSPECT:
            # Recovery: rescale from the clean completions that proved
            # it, restoring the table toward its profiled base.
            try:
                self.reprofile(name, n_samples=self.config.recover_after)
            except RuntimeError:
                pass
        for fn in list(self.listeners):
            fn(name, old, new)


class ClusterScheduler:
    def __init__(
        self,
        loop: Optional[EventLoop] = None,
        execution=None,
        watchdog: Optional[WatchdogConfig] = None,
        retry_backoff: float = 0.02,
        retry_max_backoff: float = 1.0,
    ):
        self.loop = loop if loop is not None else EventLoop()
        self.execution = execution
        self.slices: Dict[str, Slice] = {}
        # request -> slice name, for failure recovery:
        self.placement: Dict[int, str] = {}
        self.requests: Dict[int, Request] = {}
        self.dropped: List[Request] = []
        self.reroutes = 0
        # Placement audit trail: (request_id, ((slice, utilization), ...)
        # in try order, chosen slice or None). The spill-order tests (and
        # any postmortem of a mis-placed request) read this. Bounded: a
        # live cluster submits for the process lifetime, so an unbounded
        # per-submission log would be a slow leak.
        self.placement_attempts: Deque[
            Tuple[int, Tuple[Tuple[str, float], ...], Optional[str]]
        ] = deque(maxlen=4096)
        # Evictions from the bounded audit trail above — the overflow
        # count keeps the total submission volume reconstructible.
        self.placement_attempts_overflow = 0
        # Failover audit: displaced request -> re-admitted tail request id
        # (None = shed). Requests whose frames had all arrived when their
        # slice died have nothing to re-admit and land in
        # ``finished_with_slice`` instead — between the three records,
        # no request placed on a failed slice goes unaccounted.
        self.failover_map: Dict[int, Optional[int]] = {}
        self.finished_with_slice: List[int] = []
        # Health machinery. ``watchdog`` arms the full loop (device
        # watchdogs are built by the factories from the same config);
        # without it the monitor still exists so operator-driven
        # fail_slice keeps a single audit/notification path.
        self.watchdog = watchdog
        self.health = SliceHealthMonitor(self, watchdog)
        # Deadline-aware retry queue for displaced tails that no
        # surviving slice could accept at the failover instant:
        # origin request id -> ParkedTail. Every parked entry resolves to
        # exactly one of ``parked_admitted`` / ``parked_expired``.
        self.retry_backoff = retry_backoff
        self.retry_max_backoff = retry_max_backoff
        self.parked: Dict[int, ParkedTail] = {}
        self.parked_admitted: List[int] = []
        self.parked_expired: List[int] = []
        # Subset of parked_expired withdrawn by their rehome owner
        # (transport eviction) rather than by clock expiry.
        self.parked_cancelled: List[int] = []
        # Session re-homing hook (the transport server registers here):
        # an object with owns(rid) / rehomed(origin_rid, tail, slice) /
        # expired(origin_rid). Tails it owns are re-admitted as EXTERNAL
        # requests — the owner replays the real buffered bytes into them
        # instead of the cluster streaming synthetic frames.
        self.rehome_owner = None
        # Frame-lifecycle tracer (core/telemetry.py); attach_tracer wires
        # every slice's pipeline plus the health monitor.
        self.tracer = None
        # Extra snapshot sections: name -> zero-arg callable returning a
        # JSON-able dict. The live factory registers engine probes here
        # (arena occupancy, staging-ring reuse) so telemetry_snapshot
        # folds execution-substrate state in without core importing it.
        self.telemetry_probes: Dict[str, Callable[[], Dict]] = {}

    def set_rehome_owner(self, owner) -> None:
        self.rehome_owner = owner

    # -- elasticity ------------------------------------------------------
    def add_slice(self, spec: SliceSpec) -> Slice:
        return self.register(Slice(spec, self.loop, execution=self.execution))

    def register(self, sl: Slice) -> Slice:
        """Add a pre-built slice (the live factory's entry point)."""
        self.slices[sl.spec.name] = sl
        if self.tracer is not None:
            sl.scheduler.attach_tracer(self.tracer, tag=sl.spec.name)
        return sl

    def attach_tracer(self, tracer) -> None:
        """Enable frame-lifecycle tracing cluster-wide: every slice's
        pipeline (tagged with the slice name) plus the health monitor's
        watchdog/transition lane. Slices registered later inherit the
        tracer. ``tracer=None`` detaches everywhere."""
        self.tracer = tracer
        self.health.tracer = tracer
        for sl in self.slices.values():
            sl.scheduler.attach_tracer(tracer, tag=sl.spec.name)

    def mark_slow(self, name: str, factor: Optional[float] = None) -> float:
        """Straggler: scale the slice's WCET table for future admissions;
        running work is absorbed by the paper's adaptation machinery.

        ``factor=None`` re-profiles live: the scale is the MEASURED
        drift (quantile of actual/expected over recent completions,
        tracked by the health monitor) instead of an operator-supplied
        stale guess. An explicit factor is still accepted for tests and
        forced degradation."""
        if factor is None:
            return self.health.reprofile(name)
        self._rescale(name, factor)
        return factor

    def _rescale(self, name: str, factor: float) -> None:
        sl = self.slices[name]
        sl.slow_factor = factor
        sl.scheduler.table = sl.spec.table.scaled(factor)
        sl.scheduler.admission.table = sl.scheduler.table

    def fail_slice(self, name: str) -> List[Request]:
        """Fail-stop a slice; re-admit its unfinished requests elsewhere.

        Live slices are shut down first (device closed, engine frozen),
        so the dead slice's arena rows are never touched again; each
        displaced request's remaining tail is re-admitted through the
        normal placement + admission + lease path, which allocates rows
        on SURVIVING slices' resident arenas.

        Tails that no surviving slice can accept at the failover instant
        are PARKED in the deadline-aware retry queue (``parked``) and
        retried with backoff until admitted or provably past their last
        frame's arrival — they are returned for visibility, not shed.
        Frames already delivered to the dead slice that never completed
        are reconciled into its ``Metrics.lost_frames`` exactly once, so
        ``completed + dropped + lost == ingested`` holds across failure.

        Failing a slice twice (or an unknown name) raises instead of
        silently double-displacing requests and corrupting the failover
        accounting."""
        if name not in self.slices:
            raise KeyError(
                f"fail_slice: unknown slice {name!r} (have: {sorted(self.slices)})"
            )
        sl = self.slices[name]
        if not sl.alive:
            raise RuntimeError(
                f"fail_slice: slice {name!r} already failed; failing it again "
                f"would re-displace its requests and corrupt failover accounting"
            )
        if sl.health != QUARANTINED:
            # Operator-initiated failure takes the same audit +
            # notification path as a watchdog quarantine (listeners —
            # e.g. the ingest gateway aborting this slice's sessions —
            # must fire before deliveries are reconciled below).
            self.health._set_state(name, QUARANTINED, "fail_slice (operator)")
        sl.shutdown()
        displaced: List[Tuple[int, Request]] = []
        finished_now: List[int] = []
        now = self.loop.now
        for rid, placed_on in list(self.placement.items()):
            if placed_on != name:
                continue
            req = self.requests[rid]
            del self.placement[rid]
            if req.end_time <= now:
                # Already fully arrived; in-flight frames lost with the
                # slice, nothing left to re-admit.
                self.finished_with_slice.append(rid)
                finished_now.append(rid)
                continue
            # Frames with arrival <= now are lost with the slice. floor,
            # not int(): a request whose start is still in the future
            # (e.g. a tail re-admitted by an earlier failover) has a
            # negative elapsed fraction, and int()'s truncation toward
            # zero would count one phantom arrived frame.
            arrived = math.floor((now - req.start_time) / req.period) + 1
            remaining = req.n_frames - max(0, arrived)
            if remaining <= 0:
                self.finished_with_slice.append(rid)
                finished_now.append(rid)
                continue
            # Re-admit the remaining tail as a fresh request.
            tail = Request(
                category=req.category,
                period=req.period,
                relative_deadline=req.relative_deadline,
                n_frames=remaining,
                start_time=now + req.period,
            )
            displaced.append((rid, tail))
        # Reconcile frames that died in the dead slice's pipeline
        # (delivered but never completed: DisBatcher windows, the EDF
        # queue, and the in-flight job whose completion is swallowed).
        m = sl.scheduler.metrics
        in_pipeline = m.delivered_frames - m.completed_frames - m.lost_frames
        if in_pipeline > 0:
            m.record_lost(in_pipeline)
        parked_now: List[Request] = []
        owner = self.rehome_owner
        # Requests with no deliverable tail are OVER at the failover
        # instant: resolve their owner's session now (same callback as a
        # parked tail expiring), or a transport session aborted into
        # ``failover`` state would wait forever for a re-home that is
        # never coming. ``finished_with_slice`` stays their ledger —
        # they never enter ``failover_map``.
        for rid in finished_now:
            if owner is not None and owner.owns(rid):
                owner.expired(rid)
        for rid, tail in displaced:
            owned = owner is not None and owner.owns(rid)
            if self._try_place(tail, external_arrivals=owned):
                self.failover_map[rid] = tail.request_id
                self.reroutes += 1
                if owned:
                    owner.rehomed(rid, tail, self.placement[tail.request_id])
            else:
                self._park(rid, tail, external=owned)
                parked_now.append(tail)
        return parked_now

    # -- parked-tail retry queue ------------------------------------------
    def _park(self, origin_rid: int, tail: Request, external: bool = False) -> None:
        entry = ParkedTail(
            origin_rid=origin_rid, tail=tail, parked_at=self.loop.now,
            external=external,
        )
        self.parked[origin_rid] = entry
        self._schedule_retry(entry)

    def _schedule_retry(self, entry: ParkedTail) -> None:
        tail = entry.tail
        delay = min(
            max(self.retry_backoff, tail.period) * (2 ** entry.attempts),
            self.retry_max_backoff,
        )
        # Deadline-aware: never sleep past the instant the tail provably
        # expires (one period after its last frame's arrival) — the retry
        # landing there resolves the entry as expired, so every parked
        # tail terminates in bounded time.
        expiry = tail.start_time + (tail.n_frames - 1) * tail.period + tail.period
        when = max(min(self.loop.now + delay, expiry), self.loop.now)
        self.loop.schedule(
            when,
            partial(self._retry_parked, entry.origin_rid),
            priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
        )

    def _retry_parked(self, origin_rid: int) -> None:
        entry = self.parked.get(origin_rid)
        if entry is None:
            return
        tail = entry.tail
        now = self.loop.now
        # Frames whose arrival passed while parked are gone (same floor
        # rule as fail_slice); what is still deliverable shrinks as time
        # passes because the tail keeps its original clock.
        arrived = math.floor((now - tail.start_time) / tail.period) + 1
        remaining = tail.n_frames - max(0, arrived)
        owner = self.rehome_owner if entry.external else None
        if remaining <= 0:
            del self.parked[origin_rid]
            self.parked_expired.append(origin_rid)
            self.failover_map[origin_rid] = None
            if owner is not None:
                owner.expired(origin_rid)
            return
        fresh = Request(
            category=tail.category,
            period=tail.period,
            relative_deadline=tail.relative_deadline,
            n_frames=remaining,
            start_time=now + tail.period,
        )
        if self._try_place(fresh, external_arrivals=entry.external):
            del self.parked[origin_rid]
            self.parked_admitted.append(origin_rid)
            self.failover_map[origin_rid] = fresh.request_id
            self.reroutes += 1
            if owner is not None:
                owner.rehomed(origin_rid, fresh, self.placement[fresh.request_id])
            return
        entry.attempts += 1
        self._schedule_retry(entry)

    def cancel_parked(self, origin_rid: int) -> bool:
        """Owner-initiated withdrawal of a parked tail (the transport
        evicted the session it belonged to): the entry resolves as
        expired-by-cancellation and can never be re-admitted. No
        ``rehome_owner.expired`` callback — the owner asked. The pending
        retry finds the entry gone and is a no-op."""
        entry = self.parked.pop(origin_rid, None)
        if entry is None:
            return False
        self.parked_expired.append(origin_rid)
        self.parked_cancelled.append(origin_rid)
        self.failover_map[origin_rid] = None
        return True

    # -- placement + admission --------------------------------------------
    def submit_request(
        self, request: Request, external_arrivals: bool = False
    ) -> bool:
        """``external_arrivals`` is forwarded to the chosen slice's
        scheduler: the ingest gateway registers streams through the
        SAME placement/admission/lease path but delivers the frames
        itself (``DeepRT.ingest_frame``)."""
        if self._try_place(request, external_arrivals=external_arrivals):
            return True
        self.dropped.append(request)
        return False

    def _try_place(
        self, request: Request, external_arrivals: bool = False
    ) -> bool:
        """Placement + admission without the drop bookkeeping: shared by
        fresh submissions (which record a drop on failure) and parked-
        tail retries (which park again instead). Only HEALTHY slices are
        candidates — a SUSPECT slice keeps serving what it has but takes
        no new placements until it recovers."""
        ranked = sorted(
            ((sl.utilization(), sl.spec.name, sl)
             for sl in self.slices.values()
             if sl.health == HEALTHY and sl.hosts(request)),
            key=lambda t: (t[0], t[1]),
        )
        chosen: Optional[str] = None
        for _u, _name, sl in ranked:
            if not sl.can_lease(request):
                continue  # no free arena row for a new decode stream: spill
            result = sl.scheduler.submit_request(
                request, external_arrivals=external_arrivals
            )
            if result.admitted:
                sl.lease(request)
                self.placement[request.request_id] = sl.spec.name
                self.requests[request.request_id] = request
                chosen = sl.spec.name
                break
        if len(self.placement_attempts) == self.placement_attempts.maxlen:
            self.placement_attempts_overflow += 1
        self.placement_attempts.append(
            (request.request_id,
             tuple((name, u) for u, name, _ in ranked), chosen)
        )
        return chosen is not None

    # -- metrics ----------------------------------------------------------
    def run(self, until: Optional[float] = None) -> None:
        self.loop.run(until)

    def aggregate_metrics(self) -> Dict[str, float]:
        total = missed = jobs = shed = lost = delivered = retries = 0
        e2e = LatencyHistogram()
        for sl in self.slices.values():
            m = sl.scheduler.metrics
            total += m.completed_frames
            missed += m.missed_frames
            jobs += m.job_count
            shed += m.dropped_frames
            lost += m.lost_frames
            delivered += m.delivered_frames
            retries += m.submit_retries
            # Streaming histograms, not raw sample lists: correct (and
            # O(1) memory) even with Metrics.record_samples off.
            e2e.merge(m.e2e_hist)
        return {
            "completed_frames": total,
            "missed_frames": missed,
            "miss_rate": missed / total if total else 0.0,
            "jobs": jobs,
            "dropped_requests": len(self.dropped),
            "dropped_frames": shed,
            "lost_frames": lost,
            "ingested_frames": delivered + shed,
            "submit_retries": retries,
            "mean_e2e_latency": e2e.mean,
            "e2e_p50": e2e.percentile(0.50),
            "e2e_p95": e2e.percentile(0.95),
            "e2e_p99": e2e.percentile(0.99),
            "max_e2e_latency": e2e.vmax,
            "reroutes": self.reroutes,
            "parked": len(self.parked),
            "parked_admitted": len(self.parked_admitted),
            "parked_expired": len(self.parked_expired),
            "parked_cancelled": len(self.parked_cancelled),
        }

    def telemetry_snapshot(self) -> Dict:
        """One JSON-able tree of everything observable about the
        cluster: aggregate + per-slice frame metrics, slice health and
        utilization, chunk-depth histograms and bounded-log overflow
        counters, watchdog statistics, registered execution-substrate
        probes (arena occupancy, staging-ring reuse — see
        ``telemetry_probes``), and — when a tracer is attached — the
        tracer's ring stats and full deadline-miss attribution. The
        transport server embeds this into its STATUS reply; never the
        other way around (no recursion)."""
        slices = {}
        for name, sl in self.slices.items():
            m = sl.scheduler.metrics
            w = sl.scheduler.worker
            slices[name] = {
                "health": sl.health,
                "alive": sl.alive,
                "utilization": sl.utilization() if sl.alive else 0.0,
                "slow_factor": sl.slow_factor,
                "completed_frames": m.completed_frames,
                "missed_frames": m.missed_frames,
                "dropped_frames": m.dropped_frames,
                "lost_frames": m.lost_frames,
                "delivered_frames": m.delivered_frames,
                "latency": m.latency_hist.to_dict(),
                "e2e": m.e2e_hist.to_dict(),
                "chunk_depths": {str(k): v for k, v in
                                 sorted(w.chunk_depth_counts.items())},
                "chunk_log_overflow": w.chunk_log_overflow,
                "leases": len(sl.leases),
                "admission": dict(sl.scheduler.admission.stats),
                "adaptation": sl.scheduler.adaptation.telemetry(),
            }
        h = self.health
        snap = {
            "aggregate": self.aggregate_metrics(),
            "slices": slices,
            "placement_attempts_overflow": self.placement_attempts_overflow,
            "watchdog": {
                "transitions": len(h.transitions),
                "reprofiles": dict(h.reprofiles),
                "submit_errors": dict(h.submit_errors),
            },
        }
        for name, probe in self.telemetry_probes.items():
            snap[name] = probe()
        if self.tracer is not None:
            snap["tracer"] = self.tracer.snapshot()
            snap["attribution"] = self.tracer.attribution()
        return snap

    def telemetry_text(self) -> str:
        """``/metrics``-style text exposition of the snapshot."""
        return render_text(self.telemetry_snapshot())


def build_sim_cluster(
    table_fn: Callable[[], ProfileTable],
    slice_names: Sequence[str],
    fault_plans: Optional[Dict[str, FaultPlan]] = None,
    watchdog: Optional[WatchdogConfig] = None,
    execution=None,
    utilization_bound: float = 1.0,
    loop: Optional[EventLoop] = None,
) -> ClusterScheduler:
    """Simulated cluster with fault injection and the health watchdog.

    Every slice's ``SequentialDevice`` is wrapped in a
    :class:`~repro.core.faults.FaultyDevice` (an empty plan for slices
    not named in ``fault_plans``), and when ``watchdog`` is given each
    wrapper carries a :class:`~repro.core.faults.CompletionWatchdog` plus
    measured-completion reporting wired to the cluster's
    ``SliceHealthMonitor`` — the exact topology the live factory
    (``serving.batcher_bridge.build_live_cluster``) builds around
    ``AsyncDevice``, but in virtual time, so fault scenarios that take
    wall-clock minutes replay in milliseconds.

    ``table_fn`` is called once per slice so re-profiling rescales stay
    per-slice.
    """
    cluster = ClusterScheduler(loop=loop, execution=execution, watchdog=watchdog)
    plans = dict(fault_plans or {})
    unknown = set(plans) - set(slice_names)
    if unknown:
        raise ValueError(f"fault plans for unknown slices: {sorted(unknown)}")
    for name in slice_names:
        spec = SliceSpec(
            name=name, table=table_fn(), utilization_bound=utilization_bound
        )
        wd = None
        if watchdog is not None:
            wd = CompletionWatchdog(
                cluster.loop, watchdog,
                on_overdue=partial(cluster.health.note_overdue, name),
            )
        device = FaultyDevice(
            SequentialDevice(cluster.loop),
            plans.get(name, FaultPlan()),
            watchdog=wd,
            on_measured=(
                partial(cluster.health.note_complete, name)
                if watchdog is not None else None
            ),
            on_submit_error=partial(cluster.health.note_submit_error, name),
        )
        sched = DeepRT(
            spec.table, loop=cluster.loop, execution=execution,
            utilization_bound=utilization_bound, device=device,
        )
        cluster.register(Slice(spec, cluster.loop, scheduler=sched))
    return cluster
