"""The frame log of one window and the end-to-end numbers read from it.

Every frame of every offered stream that was due in the window is one
``Frame``: its tokens, when its source's plan made it due (open loop),
its relative deadline, whether its stream was admitted, whether the
gateway shed it, and when it completed (None: shed at the gateway,
lost, or never completed).

- ``attempted``: every frame offered and due in the window, of admitted
  and refused streams alike: the seed and the cell fix it.
- ``failed``: frames of admitted streams that were never answered:
  neither shed by the gateway's policy nor completed once the run has
  drained. A sound program has none. Refusal, shedding and lateness are
  the scheduler's answers under load, counted by the goodput and by
  ``missed``.
- ``missed``: frames of admitted streams not answered in time (DeepRT's
  miss count): shed, lost, never completed, completed after their
  plan's due time plus their relative deadline, or served by a job that
  ran below the frame's shape (the adaptation module's shrink crops a
  prompt: not the answer asked for).
- ``goodput_tok_s``: tokens of admitted streams' frames completed by
  their deadline, over the window's seconds. A prompt frame counts its
  length, a decode frame 1; refused streams' frames count 0.
- ``p95_latency_ms``: the exact 95th percentile (nearest rank) of
  completion minus due time over admitted streams' frames, an
  uncompleted frame counting as infinite. Where the rank falls on one of those, the tail
  has no finite value and ``NO_TAIL_MS`` stands for it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

NO_TAIL_MS = 1.0e9


@dataclass
class Frame:
    cls: str
    rid: int
    index: int
    tokens: int
    due: float
    deadline: float  # relative, seconds
    admitted: bool
    completion: Optional[float] = None
    shed: bool = False  # dropped at the gateway by its shed policy
    degraded: bool = False  # its job ran below the frame's shape (a cropped prompt)

    @property
    def latency(self) -> float:
        if self.completion is None:
            return math.inf
        return self.completion - self.due

    @property
    def on_time(self) -> bool:
        return (not self.degraded and self.completion is not None
                and self.completion <= self.due + self.deadline)


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The exact q-quantile by nearest rank: the ceil(q * n)-th smallest."""
    if not values:
        raise ValueError("no values")
    if not 0.0 < q <= 1.0:
        raise ValueError(f"q must be in (0, 1], got {q}")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q * len(ordered))) - 1]


def summarize(frames: List[Frame], seconds: float) -> Dict[str, float]:
    admitted = [f for f in frames if f.admitted]
    on_time = [f for f in admitted if f.on_time]
    out: Dict[str, float] = {
        "attempted": len(frames),
        "failed": sum(1 for f in admitted if not f.shed and f.completion is None),
        "admitted_frames": len(admitted),
        "missed": len(admitted) - len(on_time),
        "goodput_tok_s": sum(f.tokens for f in on_time) / seconds,
    }
    if admitted:
        p95 = nearest_rank([f.latency for f in admitted], 0.95)
        out["p95_latency_ms"] = NO_TAIL_MS if math.isinf(p95) else p95 * 1e3
    return out


def by_class(frames: List[Frame]) -> Dict[str, Dict[str, float]]:
    """Per stream class: frames of admitted streams, on time, shed at the gateway,
    completed late, served shrunk, never completed, and the median and
    95th percentile latency of the completed ones (ms)."""
    out: Dict[str, Dict[str, float]] = {}
    for f in frames:
        if not f.admitted:
            continue
        c = out.setdefault(f.cls, dict(admitted=0, on_time=0, shed=0, late=0, shrunk=0,
                                       never=0, done_ms=[]))
        c["admitted"] += 1
        if f.on_time:
            c["on_time"] += 1
        elif f.shed:
            c["shed"] += 1
        elif f.completion is None:
            c["never"] += 1
        elif f.degraded:
            c["shrunk"] += 1
        else:
            c["late"] += 1
        if f.completion is not None:
            c["done_ms"].append(f.latency * 1e3)
    for c in out.values():
        done = c.pop("done_ms")
        if done:
            c["done_p50_ms"] = nearest_rank(done, 0.5)
            c["done_p95_ms"] = nearest_rank(done, 0.95)
    return out
