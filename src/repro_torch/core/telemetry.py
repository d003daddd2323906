"""Frame-lifecycle tracing + deadline-miss attribution (observability).

The scheduler's whole argument is about *where* a frame's latency budget
goes — wire delay, reorder-buffer residency, DisBatcher window wait, EDF
queueing, device execution, overrun — yet counters alone can only say
THAT a deadline was missed. This module is the unified telemetry layer
from wire to completion:

- :class:`FrameTracer` — a low-overhead, loop-generic tracer. Components
  hold a ``tracer`` attribute (default ``None`` — the zero-cost off
  path: one identity check per hook) and stamp span events for every hop
  a frame takes: wire send/receive, reassembly delivery, gateway
  ingest/shed, admission verdicts, window close, EDF enqueue/dispatch,
  chunk fuse, device submit/complete, watchdog verdicts, health
  transitions. Events land in a FIXED-CAPACITY ring (old events evict,
  counted — a tracer left on for a week cannot leak), and the tracer
  only ever reads timestamps its caller passes from ``loop.now``, so it
  works identically under the virtual ``EventLoop`` and the live
  ``WallClock`` (the ``FaultPlan``/``LinkPlan`` convention).
- Deadline-miss attribution — per-frame stamps are folded, at the
  frame's TERMINAL span (exactly one of ``completed`` / ``late`` /
  ``shed`` / ``lost``, mirroring the conservation identity
  ``completed + dropped + lost == ingested``), into a per-stage budget
  breakdown: wire / reorder_buffer / window / queue / device / overrun.
  The stages are consecutive stamp deltas, so they sum EXACTLY to the
  frame's observed latency; late frames' breakdowns aggregate per
  category and per slice (which stage ate the slack), and each miss is
  kept in a capped log for postmortems.
- :class:`LatencyHistogram` — streaming fixed-log-bucket percentiles
  (p50/p95/p99 without storing samples): ``Metrics`` keeps these always
  and its unbounded sample lists only behind ``record_samples``, so a
  scheduler serving millions of frames holds O(1) metric memory.
- Chrome ``trace_event`` export (:meth:`FrameTracer.chrome_trace`) for
  timeline viewing in ``chrome://tracing`` / Perfetto, and a generic
  ``/metrics``-style text exposition (:func:`render_text`) over the
  cluster's JSON snapshot (``ClusterScheduler.telemetry_snapshot``).

Adding a stage: pick a constant below, ``emit`` it from the component
with ``loop.now``, and — if it should participate in attribution — stamp
it in ``_STAMP_STAGES`` so the breakdown picks it up. Stages not listed
there are annotation lanes (admission, watchdog, health) that ride the
ring for the timeline but never shift attribution.
"""
from __future__ import annotations

import json
import math
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

# ---------------------------------------------------------------------------
# Span taxonomy
# ---------------------------------------------------------------------------

# Frame-lifecycle hops (in pipeline order).
WIRE_SEND = "wire_send"                # client put the datagram on the wire
WIRE_RECV = "wire_recv"                # server first saw the datagram
REASSEMBLY = "reassembly_deliver"      # in-order release from the reorder buffer
INGEST = "ingest"                      # deadline-stamped into the scheduler
WINDOW_CLOSE = "window_close"          # DisBatcher joint batched the frame
EDF_ENQUEUE = "edf_enqueue"            # job pushed into the deadline queue
EDF_DISPATCH = "edf_dispatch"          # job popped + started on the device
CHUNK_FUSE = "chunk_fuse"              # depth decision for a fused dispatch
DEVICE_SUBMIT = "device_submit"        # handed to the device contract
DEVICE_COMPLETE = "device_complete"    # device completion (carries dur)
DEVICE_MEASURED = "device_measured"    # live measured-vs-expected report

# Annotation lanes (never part of a frame's attribution chain).
ADMISSION = "admission"                # admission verdict for a request
WATCHDOG_OVERDUE = "watchdog_overdue"  # completion watchdog fired
HEALTH_TRANSITION = "health_transition"  # slice health state change

# Terminal spans: every delivered frame's trace ends in EXACTLY one.
COMPLETED = "completed"                # finished at or before its deadline
LATE = "late"                          # finished past its deadline (a miss)
SHED = "shed"                          # dropped at the gateway / late-rejected
LOST = "lost"                          # destroyed (wire loss / died with slice)
TERMINAL_STAGES = frozenset({COMPLETED, LATE, SHED, LOST})

# Attribution stage names, in budget order.
ATTR_STAGES = ("wire", "reorder_buffer", "window", "queue", "device", "overrun")

# emit()-stage -> stamp slot consumed by the attribution fold.
_STAMP_STAGES = {
    WIRE_RECV: "recv",
    REASSEMBLY: "deliver",
    INGEST: "ingest",
    WINDOW_CLOSE: "window_close",
    EDF_DISPATCH: "dispatch",
}


class SpanEvent(NamedTuple):
    """One structured span event in the ring."""

    t: float
    stage: str
    rid: int          # request id (-1: system-level event)
    idx: int          # frame index within the request (-1: system-level)
    where: Optional[str]   # slice name / component tag
    cat: Optional[str]     # category label
    meta: Optional[Dict]   # small free-form payload (kept JSON-able)


class FrameTracer:
    """Fixed-capacity ring of span events + miss attribution.

    One tracer instance spans the whole stack (transport, gateway, every
    slice's scheduler): components tag their events with ``where`` so a
    single ring still separates slices in the export. All methods run on
    the loop thread (the AsyncDevice/WallClock posting convention keeps
    completions there), so no locking is needed.
    """

    def __init__(self, capacity: int = 65536, miss_log_cap: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.ring: deque = deque(maxlen=capacity)
        self.emitted = 0          # total events ever emitted
        self.evicted = 0          # events pushed out of the full ring
        # (rid, idx) -> in-flight stamp dict; popped at the terminal span,
        # so steady-state size is bounded by frames in flight.
        self._open: Dict[Tuple[int, int], Dict[str, float]] = {}
        # Per-frame breakdowns of deadline misses (postmortem log).
        self.miss_log: deque = deque(maxlen=miss_log_cap)
        self.miss_log_overflow = 0
        # terminal kind -> (by-category, by-slice) aggregation maps of
        # (scope key -> stage -> seconds). LATE frames answer "which
        # stage ate the slack"; SHED/LOST frames get the partial chain
        # up to their terminal (where did they spend their life before
        # being dropped/destroyed).
        self._attr: Dict[str, Tuple[Dict[str, Dict[str, float]],
                                    Dict[str, Dict[str, float]]]] = {
            LATE: ({}, {}), SHED: ({}, {}), LOST: ({}, {}),
        }
        # Terminal accounting: stage -> count (conservation mirror).
        self.terminals: Dict[str, int] = {}

    # -- hot path ----------------------------------------------------------
    def emit(
        self,
        stage: str,
        t: float,
        rid: int = -1,
        idx: int = -1,
        where: Optional[str] = None,
        cat: Optional[str] = None,
        meta: Optional[Dict] = None,
    ) -> None:
        """Record one span event at time ``t`` (the caller's ``loop.now``
        — virtual or wall, the tracer never reads a clock itself)."""
        ring = self.ring
        if len(ring) == self.capacity:
            self.evicted += 1
        ring.append(SpanEvent(t, stage, rid, idx, where, cat, meta))
        self.emitted += 1
        if rid < 0 or idx < 0:
            return
        slot = _STAMP_STAGES.get(stage)
        if slot is not None:
            stamps = self._open.get((rid, idx))
            if stamps is None:
                stamps = self._open[(rid, idx)] = {}
            # First stamp wins (a retried dispatch re-stamps explicitly).
            if slot == "dispatch":
                stamps[slot] = t
                if meta is not None and "profiled" in meta:
                    stamps["profiled"] = meta["profiled"]
            else:
                stamps.setdefault(slot, t)
                if stage == WIRE_RECV and meta is not None and "sent_at" in meta:
                    stamps.setdefault("send", meta["sent_at"])
        elif stage in TERMINAL_STAGES:
            self.terminals[stage] = self.terminals.get(stage, 0) + 1
            stamps = self._open.pop((rid, idx), None)
            if stage != COMPLETED and stamps:
                self._finalize(stage, t, rid, idx, where, cat, stamps, meta)

    # -- attribution -------------------------------------------------------
    @staticmethod
    def _breakdown(stamps: Dict[str, float], complete: float) -> Tuple[Dict[str, float], float]:
        """Fold a frame's stamps into the per-stage budget breakdown.

        The stages are CONSECUTIVE deltas over the stamp chain
        send -> recv -> deliver/ingest -> window_close -> dispatch ->
        completion (missing hops contribute zero), so their sum
        telescopes exactly to ``complete - first_stamp`` — the observed
        latency. ``device`` is capped at the profiled WCET; the excess
        is ``overrun`` (device + overrun still equals the raw device
        residency, so the telescoping identity is preserved)."""
        send = stamps.get("send")
        recv = stamps.get("recv")
        ingest = stamps.get("ingest")
        deliver = stamps.get("deliver", ingest)
        wclose = stamps.get("window_close")
        dispatch = stamps.get("dispatch")
        # Walk the chain, defaulting each missing hop to its predecessor
        # so every delta is well-defined and non-negative-by-order.
        t0 = send if send is not None else (
            recv if recv is not None else (
                deliver if deliver is not None else (
                    wclose if wclose is not None else (
                        dispatch if dispatch is not None else complete))))
        a = recv if recv is not None else t0
        b = deliver if deliver is not None else a
        c = wclose if wclose is not None else b
        d = dispatch if dispatch is not None else c
        device_raw = complete - d
        profiled = stamps.get("profiled")
        if profiled is not None and math.isfinite(profiled):
            device = min(device_raw, profiled)
            overrun = device_raw - device
        else:
            device, overrun = device_raw, 0.0
        stages = {
            "wire": a - t0,
            "reorder_buffer": b - a,
            "window": c - b,
            "queue": d - c,
            "device": device,
            "overrun": overrun,
        }
        return stages, complete - t0

    def _finalize(
        self,
        stage: str,
        t: float,
        rid: int,
        idx: int,
        where: Optional[str],
        cat: Optional[str],
        stamps: Optional[Dict[str, float]],
        meta: Optional[Dict],
    ) -> None:
        stages, total = self._breakdown(stamps, t)
        if stage == LATE:
            entry = {
                "rid": rid, "idx": idx, "t": t, "cat": cat, "slice": where,
                "total": total, "stages": stages,
            }
            if meta is not None and "overdue" in meta:
                entry["overdue"] = meta["overdue"]
            if len(self.miss_log) == self.miss_log.maxlen:
                self.miss_log_overflow += 1
            self.miss_log.append(entry)
        by_cat, by_slice = self._attr[stage]
        for scope, key in ((by_cat, cat), (by_slice, where)):
            if key is None:
                continue
            agg = scope.get(key)
            if agg is None:
                agg = scope[key] = {s: 0.0 for s in ATTR_STAGES}
                agg["frames"] = 0
                agg["total"] = 0.0
            agg["frames"] += 1
            agg["total"] += total
            for s in ATTR_STAGES:
                agg[s] += stages[s]

    def attribution(self) -> Dict[str, Dict]:
        """Aggregated attribution: per category and per slice, seconds
        spent in each stage (plus frame count and summed observed
        latency). Top-level ``by_category``/``by_slice`` cover deadline
        MISSES (LATE frames); ``shed``/``lost`` carry the partial-chain
        breakdowns for frames dropped at the door or destroyed."""
        late_cat, late_slice = self._attr[LATE]
        out = {
            "by_category": {k: dict(v) for k, v in late_cat.items()},
            "by_slice": {k: dict(v) for k, v in late_slice.items()},
            "terminals": dict(self.terminals),
            "miss_log_overflow": self.miss_log_overflow,
        }
        for kind in (SHED, LOST):
            by_cat, by_slice = self._attr[kind]
            out[kind] = {
                "by_category": {k: dict(v) for k, v in by_cat.items()},
                "by_slice": {k: dict(v) for k, v in by_slice.items()},
            }
        return out

    def frame_spans(self, rid: int, idx: int) -> List[SpanEvent]:
        """All ring-resident events for one frame, in emit order."""
        return [e for e in self.ring if e.rid == rid and e.idx == idx]

    # -- export ------------------------------------------------------------
    def chrome_trace(self) -> Dict:
        """The ring as Chrome ``trace_event`` JSON (load in
        ``chrome://tracing`` or Perfetto). Device completions become
        duration ("X") slices spanning their execution; every other
        event is an instant ("i") on its frame's thread lane."""
        events: List[Dict] = []
        for ev in self.ring:
            args: Dict = {"frame": ev.idx}
            if ev.cat is not None:
                args["category"] = ev.cat
            if ev.meta:
                args.update(ev.meta)
            rec = {
                "name": ev.stage,
                "ts": ev.t * 1e6,  # trace_event wants microseconds
                "pid": ev.where or "system",
                "tid": f"req{ev.rid}" if ev.rid >= 0 else ev.stage,
                "args": args,
            }
            dur = ev.meta.get("dur") if ev.meta else None
            if ev.stage == DEVICE_COMPLETE and dur is not None:
                rec["ph"] = "X"
                rec["ts"] = (ev.t - dur) * 1e6
                rec["dur"] = dur * 1e6
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            events.append(rec)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def snapshot(self) -> Dict:
        """JSON-able tracer state summary for the unified snapshot."""
        return {
            "capacity": self.capacity,
            "events": len(self.ring),
            "emitted": self.emitted,
            "evicted": self.evicted,
            "open_frames": len(self._open),
            "attribution": self.attribution(),
        }


# ---------------------------------------------------------------------------
# Streaming percentiles
# ---------------------------------------------------------------------------

class LatencyHistogram:
    """Fixed log-bucket streaming histogram: p50/p95/p99 without samples.

    Buckets are geometric with ratio ``growth`` over
    ``[min_value, max_value)`` plus an underflow bucket (values below
    ``min_value``, including zero) and an overflow bucket. ``record`` is
    O(1); memory is a fixed ~``log(max/min)/log(growth)`` ints
    regardless of how many values stream through. ``percentile`` returns
    the UPPER edge of the bucket holding the requested rank, so the
    estimate is conservative and within one growth factor of the exact
    sample percentile (the property test's bound); exact ``sum``/``min``
    /``max`` are tracked alongside, so means stay exact.
    """

    __slots__ = ("min_value", "growth", "_log_growth", "_nb", "counts",
                 "n", "total", "vmin", "vmax")

    def __init__(self, min_value: float = 1e-6, max_value: float = 1e5,
                 growth: float = 1.08):
        if not (min_value > 0 and max_value > min_value and growth > 1.0):
            raise ValueError(
                f"bad histogram bounds: [{min_value}, {max_value}) x{growth}"
            )
        self.min_value = min_value
        self.growth = growth
        self._log_growth = math.log(growth)
        self._nb = int(math.ceil(math.log(max_value / min_value) / self._log_growth))
        # counts[0] = underflow, counts[1.._nb] = log buckets,
        # counts[_nb + 1] = overflow.
        self.counts = [0] * (self._nb + 2)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, v: float) -> None:
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v < self.min_value:
            self.counts[0] += 1
            return
        i = int(math.log(v / self.min_value) / self._log_growth) + 1
        if i > self._nb:
            i = self._nb + 1
        self.counts[i] += 1

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other`` into this histogram (bucket layouts must match
        — everything this repo builds uses the defaults)."""
        if (other.min_value, other.growth, other._nb) != (
                self.min_value, self.growth, self._nb):
            raise ValueError("cannot merge histograms with different buckets")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def _bucket_upper(self, i: int) -> float:
        if i == 0:
            return min(self.min_value, self.vmax)
        if i > self._nb:
            return self.vmax
        return min(self.min_value * self.growth ** i, self.vmax)

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]: the upper edge of the
        bucket containing the ``ceil(q * n)``-th smallest sample,
        clamped to the exact observed max."""
        if self.n == 0:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        rank = max(1, int(math.ceil(q * self.n)))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self._bucket_upper(i)
        return self.vmax  # unreachable; defensive

    def to_dict(self) -> Dict[str, float]:
        return {
            "count": self.n,
            "sum": self.total,
            "mean": self.mean,
            "min": self.vmin if self.n else 0.0,
            "max": self.vmax if self.n else 0.0,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


# ---------------------------------------------------------------------------
# Text exposition
# ---------------------------------------------------------------------------

def _sanitize(part: str) -> str:
    return "".join(ch if ch.isalnum() else "_" for ch in str(part))


def render_text(snapshot: Dict, prefix: str = "deeprt") -> str:
    """Flatten a JSON snapshot into ``/metrics``-style exposition lines:
    one ``<prefix>_<path> <value>`` line per numeric/boolean leaf, paths
    sorted, so the cluster snapshot scrapes like a Prometheus target."""
    lines: List[str] = []

    def walk(path: str, node) -> None:
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(f"{path}_{_sanitize(k)}", node[k])
        elif isinstance(node, bool):
            lines.append(f"{path} {int(node)}")
        elif isinstance(node, (int, float)):
            v = float(node)
            if math.isfinite(v):
                lines.append(f"{path} {node}")
        # strings / lists are annotations, not metrics: skipped.

    walk(prefix, snapshot)
    return "\n".join(lines) + "\n"
