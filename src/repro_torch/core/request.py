"""Data model for DeepRT: requests, frames, categories, job instances.

Terminology follows the paper (§3.1):

- A *request* is a periodic stream of frames from one client. Each frame
  carries a relative deadline. Different requests may use different models
  and input shapes.
- A *category* groups frames that may be batched together: same model and
  same input shape (and the same real-time class — non-RT requests are
  never co-batched with RT requests, paper §3.3).
- A *job instance* is one batched execution unit: all frames of one
  category that arrived within one DisBatcher time window.
- A *task instance* is the per-category stream of job instances — a
  non-preemptive multiframe task. It is implicit in this implementation
  (the DisBatcher holds per-category state).

Time is in float seconds throughout. In the TPU adaptation a "frame" is one
inference step (a prefill of S tokens or a decode step); the shape key
identifies the padded shape bucket the step compiles to.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Tuple

_request_ids = itertools.count()
_job_ids = itertools.count()


@dataclass(frozen=True, order=True)
class Category:
    """A batchable class of frames: same model, same shape, same RT class."""

    model_id: str
    shape_key: Tuple[int, ...]  # e.g. (3, 224, 224) or (seq_len,) for LM steps
    realtime: bool = True

    def __str__(self) -> str:
        rt = "rt" if self.realtime else "nrt"
        return f"{self.model_id}/{'x'.join(map(str, self.shape_key))}/{rt}"


@dataclass
class Request:
    """A client request: a finite periodic stream of frames (paper §3.1).

    Frame i arrives at ``start_time + i * period`` and must complete by
    arrival + ``relative_deadline``.
    """

    category: Category
    period: float
    relative_deadline: float
    n_frames: int
    start_time: float = 0.0
    request_id: int = field(default_factory=lambda: next(_request_ids))

    def __post_init__(self) -> None:
        if self.period <= 0:
            raise ValueError(f"period must be positive, got {self.period}")
        if self.relative_deadline <= 0:
            raise ValueError(
                f"relative_deadline must be positive, got {self.relative_deadline}"
            )
        if self.n_frames <= 0:
            raise ValueError(f"n_frames must be positive, got {self.n_frames}")

    def frame_arrival(self, i: int) -> float:
        return self.start_time + i * self.period

    @property
    def end_time(self) -> float:
        """Arrival time of the last frame."""
        return self.frame_arrival(self.n_frames - 1)


@dataclass
class Frame:
    """One unit of client data awaiting inference.

    ``payload`` carries the frame's real input bytes (int32 token array
    for LM categories: ``(seq,)`` for prefill frames, scalar for decode
    frames); ``None`` marks a synthetic frame (simulation traces,
    admission pseudo-frames) whose staged input is zeros. ``ingest_time``
    is when the bytes entered the system at the gateway — it equals
    ``arrival_time`` unless the gateway deferred delivery; end-to-end
    latency is measured from it.
    """

    request_id: int
    category: Category
    index: int
    arrival_time: float
    deadline: float  # absolute
    payload: Optional[object] = None  # np.ndarray when ingested
    ingest_time: Optional[float] = None
    # Filled in on completion:
    completion_time: Optional[float] = None

    @property
    def latency(self) -> Optional[float]:
        if self.completion_time is None:
            return None
        return self.completion_time - self.arrival_time

    @property
    def e2e_latency(self) -> Optional[float]:
        """Arrival-at-gateway -> completion (== ``latency`` when the
        frame was never queued upstream of the scheduler)."""
        if self.completion_time is None:
            return None
        t0 = self.ingest_time if self.ingest_time is not None else self.arrival_time
        return self.completion_time - t0

    @property
    def missed(self) -> Optional[bool]:
        if self.completion_time is None:
            return None
        return self.completion_time > self.deadline + 1e-12

    @property
    def overdue(self) -> float:
        """Positive overdue time, 0 if met (valid once completed)."""
        if self.completion_time is None:
            return 0.0
        return max(0.0, self.completion_time - self.deadline)


@dataclass
class JobInstance:
    """A batched execution unit produced by the DisBatcher.

    ``relative_deadline`` equals the time-window length used to produce it
    (paper §3.2); ``deadline`` is absolute: release_time + relative_deadline.
    ``shape_key`` may differ from ``category.shape_key`` when the Adaptation
    Module has shrunk the category (paper §4.4).
    """

    category: Category
    frames: list  # list[Frame]
    release_time: float
    relative_deadline: float
    shape_key: Tuple[int, ...]
    job_id: int = field(default_factory=lambda: next(_job_ids))
    # Execution bookkeeping:
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    profiled_wcet: Optional[float] = None

    @property
    def deadline(self) -> float:
        return self.release_time + self.relative_deadline

    @property
    def batch_size(self) -> int:
        return len(self.frames)

    def __lt__(self, other: "JobInstance") -> bool:
        # Priority-queue ordering: EDF on absolute deadline, job id tiebreak.
        return (self.deadline, self.job_id) < (other.deadline, other.job_id)


class ChunkJob:
    """An ordered run of same-category decode job instances fused into ONE
    device dispatch (a k-step scanned decode program, ``serving/engine.py``).

    Built by the EDF worker at dispatch time (never queued): the worker
    pops the earliest-deadline decode job plus the next k-1 queued jobs of
    the same category — consecutive in deadline order, so fusing them
    reorders nothing — and submits the chunk as a single unit whose
    profiled WCET is the k-step family value from the ProfileTable. Inner
    jobs keep their own deadlines and frames; completion fans back out to
    each of them in order.
    """

    __slots__ = (
        "jobs", "start_time", "completion_time", "profiled_wcet", "_queued_wcet"
    )

    def __init__(self, jobs: list):
        if not jobs:
            raise ValueError("a chunk needs at least one job")
        head = jobs[0]
        for j in jobs[1:]:
            if j.category is not head.category and j.category != head.category:
                raise ValueError("chunked jobs must share one category")
        self.jobs = list(jobs)
        self.start_time: Optional[float] = None
        self.completion_time: Optional[float] = None
        self.profiled_wcet: Optional[float] = None
        self._queued_wcet = 0.0

    @property
    def k(self) -> int:
        """Chunk depth: decode steps executed by the single dispatch."""
        return len(self.jobs)

    @property
    def category(self) -> Category:
        return self.jobs[0].category

    @property
    def shape_key(self) -> Tuple[int, ...]:
        return self.jobs[0].shape_key

    @property
    def job_id(self) -> int:
        return self.jobs[0].job_id

    @property
    def release_time(self) -> float:
        return self.jobs[0].release_time

    @property
    def deadline(self) -> float:
        """The head job's deadline — the earliest in the run (EDF order)."""
        return self.jobs[0].deadline

    @property
    def batch_size(self) -> int:
        """Widest per-step frame count (the arena executes max_slots rows
        regardless; this feeds bucket-accounting fallbacks only)."""
        return max(j.batch_size for j in self.jobs)

    @property
    def frames(self) -> list:
        """All frames across the chunk's steps, in execution order."""
        return [f for j in self.jobs for f in j.frames]


@dataclass
class PseudoJob:
    """A virtual job instance used by admission control (paper §4.2, step 2).

    Only the scheduling-relevant fields: release, execution estimate,
    relative deadline, and the frames' own deadlines for latency prediction.
    """

    category: Category
    release_time: float
    exec_time: float
    relative_deadline: float
    n_frames: int
    # (request_id, frame_index, arrival, abs deadline) for accuracy eval:
    frame_refs: tuple = ()

    @property
    def deadline(self) -> float:
        return self.release_time + self.relative_deadline
