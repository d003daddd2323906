"""Reducing the profiler's trace of the window to what the readers need.

The harness runs ``torch.profiler`` (CUDA activity only: CPU activity
would slow the loop thread that schedules) around the window in a
``--trace 1`` run, and notes the wall clock at each job's dispatch; the
profiler puts device timestamps on the same clock. Here the raw events
become:

- device activities (kernels, copies, sets) clipped to the window, the
  union of their intervals (``busy_s``) and the gaps between them;
- each device activity's job: the last job dispatched before it began.
  One job is in flight at a time (the EDF worker submits the next only
  after the completion), so a job's launches all fall between its
  dispatch and the next one's;
- per job: its device span (first start to last end), busy time, and
  time by hand-written kernel (``costs/<kernel>.py``'s ``MATCH``);
- the breakdown: device operations by total time, and the longest idle
  gaps labelled by what the host was doing then.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

TOP = 10


@dataclass
class JobDevice:
    start_ns: int
    end_ns: int
    busy_ns: int = 0
    by_kernel: Dict[str, int] = field(default_factory=dict)

    @property
    def span_ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    activities: int
    jobs: Dict[int, JobDevice]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    kernel_names: Dict[str, List[str]]  # cost kernel -> device names matched


def union_ns(intervals: Sequence[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """Total length of the union of intervals, and the gaps between them."""
    total, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def gap_label(gap: Tuple[int, int], marks: List[int], release_ns: Dict[int, int]) -> str:
    """What the host was doing while the device sat idle in ``gap``: the
    job that ran next was launching already, was released and waiting
    for the host's completion and dispatch, or not yet released."""
    a, b = gap
    n = bisect.bisect_right(marks, b) - 1  # the job whose launches end the gap
    if n < 0:
        return "before the first traced dispatch"
    if marks[n] <= a:
        return "host enqueueing the running job"
    rel = release_ns.get(n)
    if rel is not None and rel <= a:
        return "released job waiting for the host (completion, EDF pick, dispatch)"
    return "no job released (waiting for a window joint or an arrival)"


def reduce(events, window: Tuple[int, int], costs: Dict[str, object],
           marks: List[Tuple[int, int]], release_ns: Optional[Dict[int, int]] = None
           ) -> DeviceTrace:
    """``events``: the profiler's raw events (``_KinetoEvent``s, or any
    objects with ``name()``, ``start_ns()``, ``duration_ns()`` and
    ``device_type()``); ``window``: (start, end) in the events' clock,
    nanoseconds; ``marks``: (dispatch instant, job) of every job;
    ``release_ns``: job -> the instant it was released (same clock)."""
    w0, w1 = window
    release_ns = release_ns or {}
    patterns = {k: re.compile(m.MATCH) for k, m in costs.items()}
    kind_of_name: Dict[str, Optional[str]] = {}
    marks = sorted(marks)
    device: List[Tuple[int, int, str]] = []
    for e in events:
        if str(e.device_type()).endswith("CPU"):
            continue
        name = e.name()
        s = e.start_ns()
        d = e.duration_ns()
        if d <= 0 or s + d <= w0 or s >= w1:
            continue
        device.append((max(s, w0), min(s + d, w1), name))
    mark_t = [t for t, _ in marks]
    busy, gaps = union_ns([(s, e) for s, e, _ in device])
    jobs: Dict[int, JobDevice] = {}
    job_intervals: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    by_name: Dict[str, int] = defaultdict(int)
    matched: Dict[str, set] = defaultdict(set)
    for s, e, name in device:
        by_name[name] += e - s
        if name not in kind_of_name:
            kind_of_name[name] = next((k for k, p in patterns.items() if p.search(name)), None)
        i = bisect.bisect_right(mark_t, s) - 1
        if i < 0:
            continue
        n = marks[i][1]
        jd = jobs.get(n)
        if jd is None:
            jd = jobs[n] = JobDevice(s, e)
        jd.start_ns, jd.end_ns = min(jd.start_ns, s), max(jd.end_ns, e)
        job_intervals[n].append((s, e))
        k = kind_of_name[name]
        if k is not None:
            jd.by_kernel[k] = jd.by_kernel.get(k, 0) + (e - s)
            matched[k].add(name)
    for n, iv in job_intervals.items():
        jobs[n].busy_ns = union_ns(iv)[0]
    release_by_mark = {i: release_ns.get(n) for i, (_, n) in enumerate(marks)}
    labelled = sorted(((gap_label(g, mark_t, release_by_mark), (g[1] - g[0]) / 1e9)
                       for g in gaps), key=lambda x: -x[1])[:TOP]
    ops = sorted(((k[:160], v / 1e9) for k, v in by_name.items()), key=lambda x: -x[1])[:TOP]
    return DeviceTrace(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, activities=len(device), jobs=jobs,
        device_ops=[[k, v] for k, v in ops], idle_gaps=[[k, v] for k, v in labelled],
        kernel_names={k: sorted(v)[:8] for k, v in matched.items()},
    )
