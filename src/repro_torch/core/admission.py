"""Two-phase Admission Control Module (paper §4.2).

Phase 1 — utilization filter. For each category g the average number of
frames per window is ``n_g = floor(sum_m W_g / p_m)``; the estimated task
utilization is ``Ũ_s = E^{n_g} / W_g``. A pending request is rejected
outright if ``sum_g Ũ_s > 1``. This deliberately *underestimates* load
(floor, averages, optimistic interpolated lookups), so Phase 1 only
short-circuits obvious overload — admission safety rests entirely on
Phase 2, which always runs for Phase-1-passing requests.

Phase 2 — exact analysis in three steps:
  1. system-state recording: waiting frames per category, queued job
     instances, window epochs, remaining frames per request, device
     busy-until;
  2. pseudo-job generation: replay the DisBatcher forward in virtual time,
     assigning every future frame to its batching joint and looking up the
     profiled WCET per batch — linear in the number of frames;
  3. the EDF imitator (paper Algorithm 1): replay non-idling EDF over the
     pseudo jobs, advancing a clock by profiled WCETs and checking every
     virtual completion against its deadline.

Bit-exactness: joint times come from ``disbatcher.joint_time`` with the
same float operations the live DisBatcher uses, and all boundary
comparisons are exact — the imitator's schedule IS the live schedule when
execution times equal WCETs and early-flush is off (strict mode). The
imitator also returns per-frame predicted completion times, which
benchmarks/imitator_accuracy.py compares against real executions (Fig 8).

Conservatisms (all in the safe direction — no false admits):
- the imitator charges full profiled WCET; real executions at or below
  WCET plus the guarded early flush can only complete frames earlier
  (up to a bounded EDF-order perturbation, see scheduler.DeepRT);
- when the pending request shrinks a category window, the shrunk window is
  used for the whole horizon even though it could grow back after the
  tight request departs.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.disbatcher import DisBatcher, joint_time
from repro_torch.core.profiler import ProfileTable
from repro_torch.core.request import Category, PseudoJob, Request


@dataclass
class CategorySnapshot:
    """State of one category at admission time (Phase 2, step 1)."""

    category: Category
    window: float
    epoch_t0: float
    next_index: int
    # (arrival, abs_deadline, request_id, frame_index) of frames already
    # waiting in the DisBatcher queue:
    waiting: List[Tuple[float, float, int, int]] = field(default_factory=list)
    # Requests with frames still to arrive (or arriving now):
    requests: List[Request] = field(default_factory=list)
    shape_key: Optional[Tuple[int, ...]] = None  # adaptation override

    @property
    def effective_shape(self) -> Tuple[int, ...]:
        return self.shape_key or self.category.shape_key

    def joint(self, i: int) -> float:
        return joint_time(self.epoch_t0, i, self.window)


@dataclass
class SystemState:
    now: float
    device_free_at: float
    # Already-batched jobs waiting in the deadline queue:
    queued_jobs: List[PseudoJob] = field(default_factory=list)
    categories: List[CategorySnapshot] = field(default_factory=list)


@dataclass
class AdmissionResult:
    admitted: bool
    phase: int  # 0 (bypassed), 1 or 2 (which phase decided)
    utilization: float
    reason: str = ""
    # (request_id, frame_index) -> predicted completion time:
    predicted_completions: Dict[Tuple[int, int], float] = field(default_factory=dict)
    n_pseudo_jobs: int = 0


class AdmissionControl:
    def __init__(self, table: ProfileTable):
        self.table = table
        # Verdict counters for the telemetry snapshot: which phase
        # turned requests away matters for capacity planning (phase-1 =
        # raw utilization, phase-2 = deadline packing).
        self.stats = {"admitted": 0, "rejected_phase1": 0,
                      "rejected_phase2": 0}

    # ------------------------------------------------------------------
    # Phase 1: utilization-based filter.
    # ------------------------------------------------------------------
    def phase1_utilization(self, categories: List[CategorySnapshot]) -> float:
        total = 0.0
        for snap in categories:
            if not snap.requests:
                continue
            w = snap.window
            n_g = math.floor(sum(w / r.period for r in snap.requests))
            if n_g <= 0:
                continue
            e = self.table.wcet_optimistic(
                snap.category.model_id, snap.effective_shape, n_g
            )
            total += e / w
        return total

    # ------------------------------------------------------------------
    # Phase 2, step 2: pseudo-job generation (linear in #frames).
    # ------------------------------------------------------------------
    def generate_pseudo_jobs(self, state: SystemState) -> List[PseudoJob]:
        jobs: List[PseudoJob] = list(state.queued_jobs)
        for snap in state.categories:
            jobs.extend(self._category_jobs(state.now, snap))
        # Stable sort: categories are iterated in creation order, which is
        # also the live tie order for joints firing at the same instant.
        jobs.sort(key=lambda j: (j.release_time, j.deadline))
        return jobs

    def _category_jobs(self, now: float, snap: CategorySnapshot) -> List[PseudoJob]:
        w = snap.window
        base = snap.next_index
        buckets: Dict[int, List[Tuple[float, float, int, int]]] = {}

        def joint_index(arrival: float) -> int:
            """Smallest i >= base with joint(i) >= arrival, computed with
            the exact joint_time expression (estimate, then fix up)."""
            if arrival <= snap.joint(base):
                return base
            i = base + max(1, int(math.ceil((arrival - snap.joint(base)) / w)) )
            while i > base and snap.joint(i - 1) >= arrival:
                i -= 1
            while snap.joint(i) < arrival:
                i += 1
            return i

        seen: Set[Tuple[int, int]] = set()
        for rec in snap.waiting:
            buckets.setdefault(base, []).append(rec)
            seen.add((rec[2], rec[3]))
        for r in snap.requests:
            for i in range(r.n_frames):
                a = r.frame_arrival(i)
                if a < now or (r.request_id, i) in seen:
                    continue
                k = joint_index(a)
                buckets.setdefault(k, []).append(
                    (a, a + r.relative_deadline, r.request_id, i)
                )
        out = []
        for k, recs in sorted(buckets.items()):
            release = snap.joint(k)
            exec_time = self.table.wcet(
                snap.category.model_id, snap.effective_shape, len(recs)
            )
            out.append(
                PseudoJob(
                    category=snap.category,
                    release_time=release,
                    exec_time=exec_time,
                    relative_deadline=w,
                    n_frames=len(recs),
                    frame_refs=tuple(recs),
                )
            )
        return out

    # ------------------------------------------------------------------
    # Phase 2, step 3: the EDF imitator (paper Algorithm 1).
    # ------------------------------------------------------------------
    @staticmethod
    def edf_imitator(
        jobs: List[PseudoJob], start_time: float
    ) -> Tuple[bool, Dict[Tuple[int, int], float]]:
        """Replay non-idling EDF; return (schedulable, frame predictions).

        ``jobs`` must be sorted by release time. ``start_time`` is the
        moment the device is next free (now, or the in-flight job's
        completion).
        """
        predictions: Dict[Tuple[int, int], float] = {}
        q: List[Tuple[float, int, PseudoJob]] = []  # (deadline, seq, job)
        seq = 0
        t = start_time
        i = 0
        n = len(jobs)
        while q or i < n:
            if not q:
                # Idle until the next release (Algorithm 1, lines 3-5).
                t = max(t, jobs[i].release_time)
                heapq.heappush(q, (jobs[i].deadline, seq, jobs[i]))
                seq += 1
                i += 1
                # Admit everything else released by then.
                while i < n and jobs[i].release_time <= t:
                    heapq.heappush(q, (jobs[i].deadline, seq, jobs[i]))
                    seq += 1
                    i += 1
                continue
            _, _, k = heapq.heappop(q)
            t += k.exec_time
            if t > k.deadline:
                return False, predictions
            for arrival, _dl, rid, fidx in k.frame_refs:
                predictions[(rid, fidx)] = t
            while i < n and jobs[i].release_time <= t:
                heapq.heappush(q, (jobs[i].deadline, seq, jobs[i]))
                seq += 1
                i += 1
        return True, predictions

    # ------------------------------------------------------------------
    # Full admission decision.
    # ------------------------------------------------------------------
    def admit(self, state: SystemState, utilization_bound: float = 1.0) -> AdmissionResult:
        """Run Phase 1 then Phase 2 over a hypothetical state that already
        includes the pending request (the caller builds ``state`` with the
        pending request folded into its category snapshot)."""
        u = self.phase1_utilization(state.categories)
        if u > utilization_bound + 1e-9:
            self.stats["rejected_phase1"] += 1
            return AdmissionResult(
                admitted=False,
                phase=1,
                utilization=u,
                reason=f"phase-1 utilization {u:.3f} > {utilization_bound}",
            )
        jobs = self.generate_pseudo_jobs(state)
        ok, preds = self.edf_imitator(jobs, start_time=max(state.now, state.device_free_at))
        self.stats["admitted" if ok else "rejected_phase2"] += 1
        return AdmissionResult(
            admitted=ok,
            phase=2,
            utilization=u,
            reason="" if ok else "phase-2 EDF imitator found a deadline miss",
            predicted_completions=preds,
            n_pseudo_jobs=len(jobs),
        )


def phase1_from_scheduler(sched) -> float:
    """Current Phase-1 utilization of a live scheduler (duck-typed: any
    object with ``loop``/``disbatcher``/``worker``/``device``/``table``/
    ``admission`` — i.e. a ``DeepRT``). The cluster placement loop ranks
    slices by this value; it is also what the per-slice utilization-bound
    tests read, so it must see EXACTLY the state ``submit_request``'s
    admission test would see (same snapshot code, no pending fold-in).
    """
    state = snapshot_from_scheduler(
        now=sched.loop.now,
        disbatcher=sched.disbatcher,
        queued_jobs=sched.worker.queue.snapshot(),
        device_free_at=sched.device.busy_until or sched.loop.now,
        table=sched.table,
    )
    return sched.admission.phase1_utilization(state.categories)


def snapshot_from_scheduler(
    now: float,
    disbatcher: DisBatcher,
    queued_jobs,
    device_free_at: float,
    table: ProfileTable,
    pending: Optional[Request] = None,
) -> SystemState:
    """Phase 2 step 1: record live scheduler state, optionally folding a
    pending request into the hypothesis.

    The fold-in replicates DisBatcher.add_request's epoch arithmetic
    exactly so the hypothetical joint schedule is bit-identical to what
    the live DisBatcher would do after admission.
    """
    snaps: Dict[Category, CategorySnapshot] = {}
    for cat in disbatcher.categories():
        st = disbatcher.state_of(cat)
        reqs = [r for r in st.requests.values() if r.end_time >= now]
        if st.next_index is None:
            # Retired timer: a pending same-category request would restart
            # a fresh epoch; without one there is nothing to simulate.
            if pending is None or pending.category != cat:
                if st.frames:
                    # Defensive: retired with waiting frames cannot happen
                    # (_joint only retires when the queue is empty).
                    raise AssertionError("retired category with waiting frames")
                continue
            w = disbatcher.window_for(cat, reqs + [pending])
            snaps[cat] = CategorySnapshot(
                category=cat,
                window=w,
                epoch_t0=now + w,
                next_index=0,
                requests=reqs + [pending],
                shape_key=st.shape_override,
            )
            continue
        snap = CategorySnapshot(
            category=cat,
            window=st.window,
            epoch_t0=st.epoch_t0,
            next_index=st.next_index,
            waiting=[
                (f.arrival_time, f.deadline, f.request_id, f.index)
                for f in st.frames
            ],
            requests=reqs,
            shape_key=st.shape_override,
        )
        snaps[cat] = snap
        if pending is not None and pending.category == cat:
            snap.requests = snap.requests + [pending]
            new_w = disbatcher.window_for(cat, snap.requests)
            if new_w < snap.window:
                cand_new = now + new_w
                j_next = snap.joint(snap.next_index)
                if cand_new < j_next:
                    snap.epoch_t0 = cand_new
                else:
                    snap.epoch_t0 = j_next
                snap.next_index = 0
                snap.window = new_w
    if pending is not None and pending.category not in snaps:
        cat = pending.category
        w = disbatcher.window_for(cat, [pending])
        snaps[cat] = CategorySnapshot(
            category=cat,
            window=w,
            epoch_t0=now + w,
            next_index=0,
            requests=[pending],
        )
    pseudo_queued = []
    for job in queued_jobs:
        exec_time = table.wcet(job.category.model_id, job.shape_key, job.batch_size)
        pseudo_queued.append(
            PseudoJob(
                category=job.category,
                release_time=job.release_time,
                exec_time=exec_time,
                relative_deadline=job.relative_deadline,
                n_frames=job.batch_size,
                frame_refs=tuple(
                    (f.arrival_time, f.deadline, f.request_id, f.index)
                    for f in job.frames
                ),
            )
        )
    return SystemState(
        now=now,
        device_free_at=device_free_at,
        queued_jobs=pseudo_queued,
        categories=list(snaps.values()),
    )
