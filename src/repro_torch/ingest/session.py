"""Streaming ingestion gateway: bytes-arrive -> staged device buffer.

The missing front half of the serving pipeline. PRs 1-3 built everything
from the DisBatcher down (windows, EDF, slot arenas, cluster slices) but
fed it synthetic frames conjured by the scheduler itself. This module
owns the REQUEST PATH:

  FrameSource --(payload, arrival)--> StreamSession --admission/lease-->
    DeepRT.ingest_frame --DisBatcher/EDF--> engine staging ring --> device

- ``register`` runs the full stream lifecycle entry: build the Request
  from the source's declared rate, place + admission-test it through the
  EXISTING path (``ClusterScheduler.submit_request`` with per-slice
  placement and arena-row leases, or a single ``DeepRT``), and schedule
  the source's deterministic arrival plan on the scheduler's loop — the
  same plan lands identically on a virtual ``EventLoop`` (simulation)
  and a ``WallClock`` (live serving).
- Each arriving frame is deadline-stamped AT ARRIVAL
  (``DeepRT.ingest_frame``), its payload riding the Frame into the
  engine's double-buffered staging ring at dispatch.
- BACKPRESSURE + LOAD SHEDDING: before delivering, the gateway estimates
  the frame's queueing delay (device tail + queued EDF work + window
  residue + its own batch WCET). If that exceeds the session's deadline
  budget — tightened by ``AdaptationModule.shed_scale`` while the
  category carries overrun penalty — the frame is shed per the
  category's ``ShedPolicy`` (drop, or keep-1-in-k subsampling: the
  paper's resolution shrink translated to the arrival axis). Every shed
  frame is accounted in ``Metrics`` (``record_drop``), reported to the
  adaptation module (``note_shed``), and counted against the stream's
  arena-row lease (``note_dropped``) so leases still release when
  truncated streams drain. Nothing silently vanishes:
  ``ingested == delivered + dropped`` per session, and
  ``metrics.completed + metrics.dropped == metrics.ingested`` for a
  drained run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from repro_torch.core import telemetry as T
from repro_torch.core.cluster import QUARANTINED
from repro_torch.core.request import Category, Request
from repro_torch.ingest.sources import FrameSource


@dataclass(frozen=True)
class ShedPolicy:
    """Per-category arrival-side degradation policy.

    ``budget_fraction``: queueing-delay budget as a fraction of the
    stream's relative deadline — a frame predicted to wait longer than
    this before completing is already a deadline miss in the making, so
    it is degraded at the door instead of wasting device time.
    ``mode="drop"`` sheds every over-budget frame; ``mode="subsample"``
    keeps 1 in ``keep`` while over budget (a camera degrading to a lower
    frame rate rather than going dark).
    """

    budget_fraction: float = 1.0
    mode: str = "drop"
    keep: int = 2

    def __post_init__(self) -> None:
        if not 0.0 < self.budget_fraction:
            raise ValueError(
                f"budget_fraction must be positive, got {self.budget_fraction}"
            )
        if self.mode not in ("drop", "subsample"):
            raise ValueError(f"unknown shed mode {self.mode!r}")
        if self.keep < 2:
            raise ValueError(f"subsample keep must be >= 2, got {self.keep}")


@dataclass
class StreamSession:
    """One client stream's lifecycle: register -> stream -> close."""

    source: FrameSource
    request: Request
    # pending | active | rejected | closed | failover (slice quarantined:
    # deliveries stopped; the cluster re-admits the stream's tail as a
    # synthetic request on a surviving slice)
    state: str = "pending"
    slice_name: Optional[str] = None  # cluster placement (None: single)
    frames_ingested: int = 0  # bytes that arrived at the gateway
    frames_delivered: int = 0  # handed to the scheduler
    frames_dropped: int = 0  # shed at the gateway
    frames_lost: int = 0  # destroyed on the wire (transport-declared)
    # Observable backpressure state (why did a frame vanish?): the
    # transport's flow controller updates credit/downshifts, the shedder
    # stamps last_shed_reason, re-homing counts rehomes.
    credit: float = 1.0  # plan_duty / current duty (1.0 = full rate)
    downshifts: int = 0
    last_downshift_reason: Optional[str] = None
    last_shed_reason: Optional[str] = None
    # Per-term breakdown of the most recent delay estimate (device tail
    # incl. any in-flight chunk residue, queued WCET, window wait, batch
    # WCET) — stamped by ``IngestGateway.delay_estimate``.
    last_delay_breakdown: Optional[Dict[str, float]] = None
    rehomes: int = 0
    # PENDING arrival event ids only: each delivery prunes itself on
    # fire, so close() cancels exactly the undelivered tail (cancelling
    # fired ids would leak them into the loop's cancelled-set forever).
    _events: Set[int] = field(default_factory=set)
    _shed_phase: int = 0  # subsampling counter while over budget

    @property
    def request_id(self) -> int:
        return self.request.request_id

    def conserved(self) -> bool:
        """Arrival accounting invariant: nothing silently vanishes."""
        return self.frames_ingested == self.frames_delivered + self.frames_dropped


class IngestGateway:
    """Gateway over a single ``DeepRT`` or a ``ClusterScheduler``.

    ``policies`` maps ``Category`` -> ``ShedPolicy`` (``default_policy``
    otherwise); ``shedding=False`` disables the shedder entirely (the
    benchmark's no-shedding arm — frames then queue and miss instead).

    Slice health is surfaced to sessions: the gateway subscribes to the
    cluster's ``SliceHealthMonitor``. A QUARANTINED slice's sessions are
    moved to ``failover`` (deliveries stop — the slice is dead and its
    tails re-admitted elsewhere by the cluster), and a SUSPECT slice's
    sessions shed earlier because the health monitor holds that
    scheduler's adaptation module degraded
    (``AdaptationModule.DEGRADED_BUDGET_TIGHTEN`` flows through the
    ``shed_scale`` the budget already divides by).
    """

    def __init__(
        self,
        target,
        policies: Optional[Dict[Category, ShedPolicy]] = None,
        default_policy: ShedPolicy = ShedPolicy(),
        shedding: bool = True,
    ):
        self.target = target
        self.loop = target.loop
        self.policies = dict(policies or {})
        self.default_policy = default_policy
        self.shedding = shedding
        self.sessions: List[StreamSession] = []
        # Frame-lifecycle tracer (core/telemetry.py); None = off. Shed
        # verdicts are emitted here because the gateway is the only
        # component that knows WHY a frame never reached the scheduler.
        self.tracer = None
        self._is_cluster = hasattr(target, "slices")
        health = getattr(target, "health", None)
        if self._is_cluster and health is not None:
            health.subscribe(self._on_slice_health)

    # -- lifecycle --------------------------------------------------------
    def register(
        self,
        source: FrameSource,
        category: Category,
        relative_deadline: float,
        start_in: float = 0.0,
        schedule_arrivals: bool = True,
    ) -> StreamSession:
        """Admission-test and start one stream.

        The Request presented to placement/admission carries the
        source's DECLARED period — admission reasons about the admitted
        contract; the shedder reconciles the contract with the bytes
        that actually arrive (jitter, bursts, overload).
        """
        if not self._is_cluster:
            key = (category.model_id, tuple(category.shape_key))
            if key in getattr(self.target, "table").flat_entries:
                # Slot-arena decode streams need an arena-row lease so
                # their tokens land in THEIR resident row every step;
                # only the cluster path (build_live_cluster) leases.
                raise ValueError(
                    f"decode category {category} needs the cluster path "
                    f"(arena-row leases): register over build_live_cluster"
                )
        now = self.loop.now
        request = Request(
            category=category,
            period=source.period,
            relative_deadline=relative_deadline,
            n_frames=source.n_frames,
            start_time=now + start_in,
        )
        session = StreamSession(source=source, request=request)
        self.sessions.append(session)
        if self._is_cluster:
            ok = self.target.submit_request(request, external_arrivals=True)
            if ok:
                session.slice_name = self.target.placement[request.request_id]
        else:
            ok = self.target.submit_request(
                request, external_arrivals=True
            ).admitted
        if not ok:
            session.state = "rejected"
            return session
        session.state = "active"
        if not schedule_arrivals:
            # The caller (transport server) owns the frame path and
            # pushes wire arrivals through ``deliver`` itself.
            return session
        t0 = now + start_in
        prio = getattr(self.loop, "PRIO_ARRIVAL", 0)
        for index, plan in enumerate(source.plan()):
            box: Dict[str, int] = {}
            eid = self.loop.schedule(
                t0 + plan.offset,
                self._make_delivery(session, index, plan.payload, box),
                priority=prio,
            )
            box["eid"] = eid
            session._events.add(eid)
        return session

    def close(self, session: StreamSession) -> None:
        """End a stream early: cancel undelivered arrivals, release the
        arena-row lease, retire the request from its DisBatcher."""
        if session.state == "failover":
            # Evicted while its tail is parked awaiting re-admission:
            # cancel the parked retry so it can never resurrect the
            # stream, and release the dead slice's lease record.
            session.state = "closed"
            for eid in session._events:
                self.loop.cancel(eid)
            session._events.clear()
            sl = self._slice_of(session)
            if sl is not None:
                sl.release(session.request_id)
            cancel = getattr(self.target, "cancel_parked", None)
            if cancel is not None:
                cancel(session.request_id)
            return
        if session.state != "active":
            return
        session.state = "closed"
        for eid in session._events:
            self.loop.cancel(eid)
        session._events.clear()
        sched = self._scheduler_of(session)
        sl = self._slice_of(session)
        if sl is not None:
            sl.release(session.request_id)
        sched.disbatcher.remove_request(session.request)

    # -- slice health ------------------------------------------------------
    def _on_slice_health(self, name: str, old: str, new: str) -> None:
        """SliceHealthMonitor subscriber. Fires BEFORE a quarantined
        slice is failed, so undelivered arrivals are cancelled before
        ``fail_slice`` reconciles the dead pipeline's lost frames."""
        if new != QUARANTINED:
            return  # suspect tightening is read live in _over_budget
        for session in self.sessions:
            if session.slice_name == name and session.state == "active":
                self._abort(session)

    def _abort(self, session: StreamSession) -> None:
        """The session's slice died. Stop delivering: cancelled arrivals
        never count as ingested (the bytes were never presented), frames
        already in the dead pipeline are reconciled as ``lost`` by
        ``fail_slice``, and the stream's deliverable tail is re-admitted
        on a surviving slice by the cluster (as a synthetic request —
        re-homing the live byte stream itself is the transport
        follow-on). The dead slice's lease and DisBatcher entries are
        left untouched: its engine is frozen."""
        session.state = "failover"
        for eid in session._events:
            self.loop.cancel(eid)
        session._events.clear()

    # -- placement plumbing ----------------------------------------------
    def _slice_of(self, session: StreamSession):
        if not self._is_cluster or session.slice_name is None:
            return None
        return self.target.slices[session.slice_name]

    def _scheduler_of(self, session: StreamSession):
        sl = self._slice_of(session)
        return self.target if sl is None else sl.scheduler

    # -- frame path -------------------------------------------------------
    def _make_delivery(
        self, session: StreamSession, index: int, payload, box: Dict[str, int]
    ):
        def _deliver() -> None:
            session._events.discard(box.get("eid"))
            self._on_frame(session, index, payload)

        return _deliver

    def _on_frame(self, session: StreamSession, index: int, payload) -> None:
        self.deliver(session, index, payload)

    def deliver(self, session: StreamSession, index: int, payload) -> str:
        """Present one frame's bytes to the gateway; returns how the
        frame resolved: ``"delivered"`` (handed to the scheduler),
        ``"shed"`` (dropped at the door per the shed policy), ``"lost"``
        (accepted but the target device had just closed — counted
        ingested AND lost by the scheduler), or ``"refused"`` (the
        session is not active; the bytes were never presented and are
        NOT counted ingested — the caller owns their accounting)."""
        if session.state != "active":
            return "refused"
        session.frames_ingested += 1
        sched = self._scheduler_of(session)
        cat = session.request.category
        if self.shedding and self._over_budget(session, sched, cat):
            policy = self.policies.get(cat, self.default_policy)
            session._shed_phase += 1
            keep = (
                policy.mode == "subsample"
                and session._shed_phase % policy.keep == 0
            )
            if not keep:
                self._shed(session, sched, cat, index)
                return "shed"
        else:
            session._shed_phase = 0
        frame = sched.ingest_frame(
            session.request, index, payload=payload, ingest_time=self.loop.now
        )
        session.frames_delivered += 1
        return "delivered" if frame is not None else "lost"

    def _shed(
        self, session: StreamSession, sched, cat: Category, index: int = -1
    ) -> None:
        session.frames_dropped += 1
        est = getattr(session, "_last_estimate", None)
        session.last_shed_reason = (
            f"over_budget: predicted {est[0]:.4f}s > budget {est[1]:.4f}s"
            if est is not None
            else "over_budget"
        )
        sched.metrics.record_drop(session.request_id)
        sched.adaptation.note_shed(cat)
        sl = self._slice_of(session)
        if sl is not None:
            sl.note_dropped(session.request_id)
        if self.tracer is not None:
            self.tracer.emit(
                T.SHED, self.loop.now, session.request_id, index,
                where=session.slice_name, cat=str(cat),
                meta={"reason": session.last_shed_reason,
                      "breakdown": session.last_delay_breakdown})

    # -- backpressure estimate -------------------------------------------
    def delay_estimate(
        self, session: StreamSession, sched=None, cat: Optional[Category] = None
    ):
        """``(predicted_delay, budget)`` for the session's next frame —
        the quantity the shedder thresholds on, exposed so the transport
        flow controller can signal backpressure BEFORE frames shed.

        ``device_tail`` is the in-flight job's remaining occupancy from
        the device's ``busy_until``. When that job is a multi-step
        decode chunk, the EDF worker charged the chunk's FULL k-step
        WCET at submit, so the window residue of an in-flight chunk
        counts here automatically — without it, a deep chunk would look
        like a 1-step device tail and CREDIT downshifts would fire k
        steps late. The per-term breakdown of the most recent estimate
        is kept on ``session.last_delay_breakdown`` for observability
        (which term tripped a shed / downshift).
        """
        if sched is None:
            sched = self._scheduler_of(session)
        if cat is None:
            cat = session.request.category
        now = self.loop.now
        table = sched.table
        shape = sched.disbatcher.shape_override(cat) or cat.shape_key
        pending = len(sched.disbatcher.pending_frames(cat))
        device_tail = max(0.0, (sched.device.busy_until or now) - now)
        # O(1): the EDF worker maintains the queued-WCET total
        # incrementally — no per-frame walk of the deadline queue.
        queued = sched.worker.queued_wcet
        next_joint = sched.disbatcher.state_of(cat).next_joint
        window_wait = max(0.0, next_joint - now) if next_joint is not None else 0.0
        batch_wcet = table.wcet(cat.model_id, shape, pending + 1)
        delay = device_tail + queued + window_wait + batch_wcet
        session.last_delay_breakdown = {
            "device_tail": device_tail,
            "queued_wcet": queued,
            "window_wait": window_wait,
            "batch_wcet": batch_wcet,
        }
        policy = self.policies.get(cat, self.default_policy)
        # shed_scale already folds in device health: a suspect slice's
        # adaptation module is held degraded by the health monitor, so
        # every session on it sheds earlier without gateway special-casing.
        budget = (
            policy.budget_fraction
            * session.request.relative_deadline
            / sched.adaptation.shed_scale(cat)
        )
        return delay, budget

    def _over_budget(self, session: StreamSession, sched, cat: Category) -> bool:
        """Would this frame's predicted queueing delay blow its deadline
        budget? Conservative sum of everything ahead of it: the device's
        in-flight tail, all queued EDF jobs, the residue of the current
        DisBatcher window, and the WCET of the batch it would join."""
        delay, budget = self.delay_estimate(session, sched, cat)
        session._last_estimate = (delay, budget)
        return delay > budget or math.isinf(delay)
