"""DisBatcher: deadline-centric time-window batching (paper §3.2).

Frames of the same category arriving within one time window are batched at
the window joint into a single job instance whose relative deadline equals
the window length. Window length per category (paper Theorem 1):

    W_g = 1/2 * min_{m in M_g} d_m^g

With at least two window joints between any frame's arrival and its
deadline, the job instance's deadline lower-bounds every member frame's
deadline, so EDF-schedulability of job instances implies no frame misses.

Bit-exact joint arithmetic
--------------------------
The Phase-2 admission imitator must replay this machinery EXACTLY — an
epsilon disagreement about which window a boundary frame falls into
changes a job's batch (and hence its WCET and every later completion
time). Joints are therefore *epoch-indexed*: an epoch is (t0, W), with
joints at ``joint_time(t0, i, W) = t0 + i * W`` — never accumulated.
Both the live DisBatcher and the admission module compute joints through
the same ``joint_time`` helper with the same float operations, and all
boundary comparisons are exact (frames arriving exactly at a joint join
the window closing at that joint, enforced by event-loop priorities).
A window shrink starts a new epoch.

Implemented details from the paper:
- per-category recurrent countdown timers (here: event-loop timers);
- timer interval shrinks immediately when a newly admitted request has a
  smaller relative deadline (§4.3) — the pending joint is pulled in if the
  new window length would place it earlier, never pushed out;
- the early-flush optimization (§4.3), with a safety guard (see
  ``flush_early``);
- non-RT categories use a large window and are never co-batched with RT
  frames (§3.3);
- adaptation hook (§4.4): shape override for future job instances.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import telemetry as T
from repro_torch.core.request import Category, Frame, JobInstance, Request

WINDOW_FRACTION = 0.5  # Theorem 1: half of the smallest relative deadline.
NONRT_WINDOW = 10.0  # seconds; "a large time window" for non-RT requests.


def joint_time(epoch_t0: float, index: int, window: float) -> float:
    """THE joint-time expression. Live scheduling and admission analysis
    must both call this so boundary comparisons are bit-exact."""
    return epoch_t0 + index * window


@dataclass
class _CategoryState:
    window: float
    epoch_t0: float  # joints at epoch_t0 + i*window for i >= next_index
    next_index: Optional[int]  # None = timer retired
    frames: List[Frame] = field(default_factory=list)
    requests: Dict[int, Request] = field(default_factory=dict)
    timer_event: Optional[int] = None
    shape_override: Optional[Tuple[int, ...]] = None

    @property
    def next_joint(self) -> Optional[float]:
        if self.next_index is None:
            return None
        return joint_time(self.epoch_t0, self.next_index, self.window)


class DisBatcher:
    """Transforms per-frame arrivals into batched job instances.

    ``emit`` receives each new JobInstance (the deadline queue push).
    """

    def __init__(self, loop, emit: Callable[[JobInstance], None]):
        self.loop = loop
        self.emit = emit
        self._cats: Dict[Category, _CategoryState] = {}
        # Frame-lifecycle tracer (core/telemetry.py); None = off.
        self.tracer = None
        self.tracer_tag: Optional[str] = None

    # ----- request lifecycle -------------------------------------------
    def window_for(self, category: Category, requests: List[Request]) -> float:
        if not category.realtime:
            return NONRT_WINDOW
        return WINDOW_FRACTION * min(r.relative_deadline for r in requests)

    def add_request(self, request: Request) -> None:
        cat = request.category
        st = self._cats.get(cat)
        now = self.loop.now
        if st is None:
            w = self.window_for(cat, [request])
            # Epoch starts so the first joint is exactly now + w.
            st = _CategoryState(window=w, epoch_t0=now + w, next_index=0)
            st.requests[request.request_id] = request
            self._cats[cat] = st
            self._arm_timer(cat)
            return
        st.requests[request.request_id] = request
        live = [r for r in st.requests.values() if r.end_time >= now]
        new_w = self.window_for(cat, live or [request])
        if st.next_index is None:
            # Timer retired (previous requests exhausted): fresh epoch.
            st.window = new_w
            st.epoch_t0 = now + new_w
            st.next_index = 0
            self._arm_timer(cat)
            return
        if new_w < st.window:
            cand_new = now + new_w
            j_next = st.next_joint
            if cand_new < j_next:
                # Pull the joint in: new epoch anchored at now.
                st.window = new_w
                st.epoch_t0 = cand_new
                st.next_index = 0
                if st.timer_event is not None:
                    self.loop.cancel(st.timer_event)
                self._arm_timer(cat)
            else:
                # Keep the pending joint; only the spacing after it shrinks.
                st.epoch_t0 = j_next
                st.next_index = 0
                st.window = new_w
                # Timer already armed at exactly j_next; leave it.

    def remove_request(self, request: Request) -> None:
        st = self._cats.get(request.category)
        if st is not None:
            st.requests.pop(request.request_id, None)

    def categories(self) -> List[Category]:
        return list(self._cats)

    def window_of(self, category: Category) -> float:
        return self._cats[category].window

    def state_of(self, category: Category) -> _CategoryState:
        return self._cats[category]

    def active_requests(self, category: Category) -> List[Request]:
        return list(self._cats[category].requests.values())

    def pending_frames(self, category: Category) -> List[Frame]:
        return list(self._cats[category].frames)

    # ----- adaptation hook (paper §4.4) ---------------------------------
    def set_shape_override(
        self, category: Category, shape: Optional[Tuple[int, ...]]
    ) -> None:
        if category in self._cats:
            self._cats[category].shape_override = shape

    def shape_override(self, category: Category):
        st = self._cats.get(category)
        return None if st is None else st.shape_override

    # ----- frame path ----------------------------------------------------
    def on_frame(self, frame: Frame) -> None:
        st = self._cats.get(frame.category)
        if st is None:
            raise KeyError(f"frame for unregistered category {frame.category}")
        st.frames.append(frame)
        if st.next_index is None:
            # Timer retired (requests looked exhausted) but a frame still
            # arrived — gateway-driven streams are jittery, so a late
            # frame can land after the declared last arrival. Fresh epoch
            # at the current window: no frame is ever stranded without a
            # closing joint.
            st.epoch_t0 = self.loop.now + st.window
            st.next_index = 0
            self._arm_timer(frame.category)

    # ----- window machinery ----------------------------------------------
    def _arm_timer(self, cat: Category) -> None:
        st = self._cats[cat]
        # PRIO_JOINT: frames arriving exactly at the joint are processed
        # first and join the closing window (imitator convention).
        st.timer_event = self.loop.schedule(
            st.next_joint,
            lambda: self._joint(cat),
            priority=getattr(self.loop, "PRIO_JOINT", 2),
        )

    def _joint(self, cat: Category) -> None:
        st = self._cats.get(cat)
        if st is None or st.next_index is None:
            return
        st.timer_event = None
        self._flush(cat, release_time=self.loop.now)
        # NOTE: the window never grows back mid-epoch (the paper only ever
        # shrinks the countdown interval, §4.3); regrowth would also break
        # the Phase-2 imitator's conservatism. A fresh window is computed
        # only when the category fully drains and a request restarts it.
        now = self.loop.now
        live = [r for r in st.requests.values() if r.end_time >= now]
        if not live and not st.frames:
            # All requests exhausted/removed and queue drained: retire
            # the timer (a late frame re-arms it via ``on_frame``). Also
            # covers a category whose every request was removed early
            # (``IngestGateway.close``) — an empty request dict must not
            # keep the timer alive forever.
            st.next_index = None
            return
        st.next_index += 1
        self._arm_timer(cat)

    def _flush(self, cat: Category, release_time: float) -> Optional[JobInstance]:
        st = self._cats[cat]
        if not st.frames:
            return None
        frames, st.frames = st.frames, []
        job = JobInstance(
            category=cat,
            frames=frames,
            release_time=release_time,
            relative_deadline=st.window,
            shape_key=st.shape_override or cat.shape_key,
        )
        tr = self.tracer
        if tr is not None:
            label = str(cat)
            for f in frames:
                tr.emit(T.WINDOW_CLOSE, release_time, f.request_id, f.index,
                        where=self.tracer_tag, cat=label,
                        meta={"job_id": job.job_id, "batch": len(frames),
                              "window": st.window})
        self.emit(job)
        return job

    def earliest_next_joint(self, realtime_only: bool = False) -> Optional[float]:
        """Earliest pending window joint (= earliest future job release)."""
        joints = [
            st.next_joint
            for cat, st in self._cats.items()
            if st.next_joint is not None and (cat.realtime or not realtime_only)
        ]
        return min(joints) if joints else None

    def flush_early(self, wcet_fn=None) -> bool:
        """Early-flush optimization: device idle + frames waiting (§4.3).

        Flushes the category whose earliest pending frame has the earliest
        deadline (most urgent first). Returns True if a job was emitted.

        Safety guard (beyond the paper, required for the admission
        guarantee): the flushed job must complete before the earliest
        upcoming window joint of ANY category — otherwise the non-
        preemptive flushed job could block a regularly released job in a
        way the Phase-2 EDF imitator never modeled. With the guard, an
        early flush only consumes device time the imitator treated as
        idle, and it can only shrink (never delay) the batch the next
        joint emits.
        """
        best = None
        for cat, st in self._cats.items():
            if st.frames:
                d = min(f.deadline for f in st.frames)
                if best is None or d < best[0]:
                    best = (d, cat)
        if best is None:
            return False
        cat = best[1]
        if wcet_fn is not None:
            st = self._cats[cat]
            exec_est = wcet_fn(cat, st.shape_override or cat.shape_key, len(st.frames))
            next_joint = self.earliest_next_joint()
            if next_joint is not None and self.loop.now + exec_est > next_joint:
                return False
        self._flush(cat, release_time=self.loop.now)
        return True

    def has_pending_frames(self) -> bool:
        return any(st.frames for st in self._cats.values())
