"""Network transport front end: frame ingestion that survives the network.

The gateway (``ingest/session.py``) made ingestion real but in-process:
its deterministic plans arrive in order, exactly once, with no way for a
client to react to shedding, and a slice failover re-admits tails that
stream synthetic zeros. This module puts a datagram wire between the
client and the gateway and makes the whole path survive what real edge
links do — drop, duplicate, reorder, and delay frames — while keeping
every replay bit-reproducible:

  FrameSource -> TransportSource --datagrams--> SimLink(LinkPlan) -->
    TransportServer --reassembly--> IngestGateway.deliver -->
      DeepRT.ingest_frame

- THE WIRE IS A PLAN. :class:`LinkPlan` is the network analogue of
  ``core.faults.FaultPlan``: a seed-derivable per-send fault schedule
  (DROP / DUPLICATE / REORDER / DELAY). ``SimLink`` applies it under
  either clock — the same seed replays the same chaos on a virtual
  ``EventLoop`` and a live ``WallClock``. A thin UDP binding
  (:class:`UdpServerBinding` / :class:`UdpClientLink`) speaks the same
  codec over a real socket for the live path.
- ROBUST REASSEMBLY. Per-session sequence numbers with a bounded
  reorder window, duplicate suppression, late-frame rejection against
  the send-stamped age vs. the stream's relative deadline, and
  idempotent delivery into ``DeepRT.ingest_frame``: every distinct wire
  frame resolves to exactly ONE of delivered / dropped / lost, so the
  conservation identity ``completed + dropped + lost == ingested``
  extends through the transport. Frames the link destroyed are declared
  lost with the same accounting convention a closed device uses
  (``record_ingest + record_lost``), so nothing silently vanishes.
- FLOW CONTROL. Backpressure is signaled BACK to the client instead of
  shedding silently at the server: after each delivery the server reads
  the gateway's queueing-delay estimate (which already folds in
  ``AdaptationModule.shed_scale``) and, when over budget, sends a
  CREDIT message downshifting the client's duty toward 1.0 —
  ``BurstSource.duty`` is the actuator, so a 2x-overloaded burst stream
  is stretched back toward its admitted rate at the source. Credit
  decays back toward the planned duty when the backlog clears.
- SESSION RE-HOMING. The server registers as the cluster's rehome
  owner and subscribes to its health monitor: when a slice is
  quarantined and ``fail_slice`` re-admits the session's tail, the
  server rebinds the session to the tail request, drains the frames
  buffered in its reorder window into the NEW slice (real payload, not
  zeros), and asks the client to retransmit the unresolved window from
  its retransmit buffer.

Determinism caveat: everything scheduled here uses only
``loop.schedule / schedule_in / cancel / now``, so sim runs are exact;
live runs reproduce the same *plan* subject to wall-clock jitter.
"""
from __future__ import annotations

import itertools
import json
import math
import random
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core import telemetry as T
from repro_torch.core.request import Category
from repro_torch.ingest.session import IngestGateway, StreamSession
from repro_torch.ingest.sources import FrameSource, PeriodicSource

# ---------------------------------------------------------------------------
# Wire codec
# ---------------------------------------------------------------------------

MAGIC = b"DRT1"

MALFORMED = 0     # decode verdict: not a message (reason string attached)
HELLO = 1         # client -> server: open a session (control, JSON body)
HELLO_ACK = 2     # server -> client: session id + admission verdict
DATA = 3          # client -> server: one frame (binary hot path)
CREDIT = 4        # server -> client: duty downshift/upshift
REHOME = 5        # server -> client: session re-homed, retransmit window
FIN = 6           # client -> server: stream complete (total frames sent)
STATUS = 7        # probe -> server: scrape the JSON status snapshot
STATUS_REPLY = 8  # server -> probe: the snapshot
HELLO_RETRY = 9   # server -> client: admission gated, retry after backoff

_CONTROL_TYPES = frozenset(
    (HELLO, HELLO_ACK, CREDIT, REHOME, FIN, STATUS, STATUS_REPLY, HELLO_RETRY)
)

# Adversarial-wire bounds: a datagram that claims more than these is a
# counted ``malformed`` drop, never an allocation (or an exception).
MAX_NDIM = 8
MAX_DIM = 1 << 20
MAX_PAYLOAD_BYTES = 1 << 22  # 4 MiB of int32 payload per frame

_HEADER = struct.Struct("!4sB")
_DATA_HEAD = struct.Struct("!IIdB")  # session_id, seq, sent_at, ndim


@dataclass(frozen=True)
class DataMsg:
    session_id: int
    seq: int
    sent_at: float  # sender's clock at send (late rejection input)
    payload: np.ndarray


def encode_data(session_id: int, seq: int, sent_at: float, payload) -> bytes:
    # asarray, not ascontiguousarray: the latter promotes 0-d payloads
    # (decode tokens) to 1-d, silently changing the delivered shape.
    arr = np.asarray(payload, dtype=np.int32)
    parts = [
        _HEADER.pack(MAGIC, DATA),
        _DATA_HEAD.pack(session_id, seq, sent_at, arr.ndim),
        struct.pack(f"!{arr.ndim}I", *arr.shape) if arr.ndim else b"",
        arr.astype("<i4").tobytes(),
    ]
    return b"".join(parts)


def encode_control(mtype: int, body: Dict) -> bytes:
    return _HEADER.pack(MAGIC, mtype) + json.dumps(body, sort_keys=True).encode()


def decode(data: bytes) -> Tuple[int, object]:
    """Parse one datagram. NEVER raises: any input that is not a valid
    message decodes to ``(MALFORMED, reason)`` with a specific reason
    string. The wire is adversarial — a truncated header, bad magic, an
    absurd ``ndim``/dim claim, an oversized payload, or corrupt control
    JSON must be a counted drop in the rx path, not an exception that
    can kill it (and never an attacker-sized allocation)."""
    try:
        if len(data) < _HEADER.size:
            return MALFORMED, "truncated_header"
        magic, mtype = _HEADER.unpack_from(data)
        if magic != MAGIC:
            return MALFORMED, "bad_magic"
        off = _HEADER.size
        if mtype == DATA:
            if len(data) < off + _DATA_HEAD.size:
                return MALFORMED, "truncated_data_head"
            sid, seq, sent_at, ndim = _DATA_HEAD.unpack_from(data, off)
            off += _DATA_HEAD.size
            if ndim > MAX_NDIM:
                return MALFORMED, "ndim_overflow"
            if len(data) < off + 4 * ndim:
                return MALFORMED, "truncated_dims"
            shape = struct.unpack_from(f"!{ndim}I", data, off) if ndim else ()
            off += 4 * ndim
            elements = 1
            for dim in shape:
                if dim > MAX_DIM:
                    return MALFORMED, "dim_overflow"
                elements *= dim
            if 4 * elements > MAX_PAYLOAD_BYTES:
                return MALFORMED, "oversized_payload"
            if len(data) - off != 4 * elements:
                return MALFORMED, "payload_size_mismatch"
            if not math.isfinite(sent_at):
                return MALFORMED, "bad_sent_at"
            payload = np.frombuffer(data, dtype="<i4", offset=off).astype(
                np.int32
            )
            return DATA, DataMsg(sid, seq, sent_at, payload.reshape(shape))
        if mtype not in _CONTROL_TYPES:
            return MALFORMED, "unknown_type"
        if len(data) == off:
            return mtype, {}
        try:
            body = json.loads(data[off:].decode())
        except (UnicodeDecodeError, ValueError):
            return MALFORMED, "bad_control_json"
        if not isinstance(body, dict):
            return MALFORMED, "bad_control_json"
        return mtype, body
    except Exception as e:  # pragma: no cover — fuzzer safety net
        return MALFORMED, f"internal:{type(e).__name__}"


# ---------------------------------------------------------------------------
# LinkPlan: the deterministic chaos wire
# ---------------------------------------------------------------------------

DROP = "drop"            # the datagram never arrives
DUPLICATE = "duplicate"  # the datagram arrives ``copies`` times
REORDER = "reorder"      # held back long enough to land after later sends
LINK_DELAY = "link_delay"  # extra one-way latency, order usually preserved

LINK_FAULT_KINDS = (DROP, DUPLICATE, REORDER, LINK_DELAY)


@dataclass(frozen=True)
class LinkFault:
    """One injected link fault, keyed by the client's send index (every
    datagram that enters the chaotic wire counts, retransmits included —
    the wire does not know which bytes are retries)."""

    kind: str
    at_send: int
    delay: float = 0.0  # hold time for REORDER / LINK_DELAY
    copies: int = 2     # total arrivals for DUPLICATE

    def __post_init__(self) -> None:
        if self.kind not in LINK_FAULT_KINDS:
            raise ValueError(
                f"unknown link fault kind {self.kind!r}; one of {LINK_FAULT_KINDS}"
            )
        if self.at_send < 0:
            raise ValueError("at_send must be >= 0")
        if self.delay < 0.0:
            raise ValueError("delay must be >= 0")
        if self.kind in (REORDER, LINK_DELAY) and self.delay <= 0.0:
            raise ValueError(f"a {self.kind} fault must actually delay (delay > 0)")
        if self.kind == DUPLICATE and self.copies < 2:
            raise ValueError("a DUPLICATE fault needs copies >= 2")


class LinkPlan:
    """A deterministic per-send fault schedule: at most one fault per
    send index. ``arrivals(i)`` maps send ``i`` to the list of extra
    one-way delays its copies arrive with (empty = dropped)."""

    def __init__(self, specs: Tuple[LinkFault, ...] = ()) -> None:
        self.by_send: Dict[int, LinkFault] = {}
        for spec in specs:
            if spec.at_send in self.by_send:
                raise ValueError(f"duplicate link fault at send index {spec.at_send}")
            self.by_send[spec.at_send] = spec

    @property
    def specs(self) -> List[LinkFault]:
        return [self.by_send[i] for i in sorted(self.by_send)]

    def for_send(self, index: int) -> Optional[LinkFault]:
        return self.by_send.get(index)

    def arrivals(self, index: int) -> List[float]:
        spec = self.by_send.get(index)
        if spec is None:
            return [0.0]
        if spec.kind == DROP:
            return []
        if spec.kind == DUPLICATE:
            return [0.0] * spec.copies
        return [spec.delay]  # REORDER / LINK_DELAY

    def __len__(self) -> int:
        return len(self.by_send)

    @classmethod
    def from_seed(
        cls,
        seed: int,
        n_sends: int,
        p_drop: float = 0.0,
        p_dup: float = 0.0,
        p_reorder: float = 0.0,
        p_delay: float = 0.0,
        delay_range: Tuple[float, float] = (0.005, 0.05),
        reorder_hold: Tuple[float, float] = (0.05, 0.2),
        copies: int = 2,
    ) -> "LinkPlan":
        """Draw an independent fault (or none) for each send index.

        Mirrors ``FaultPlan.from_seed``: the per-index draw count is
        branch-independent, so the plan for sends ``[0, k)`` is a prefix
        of the plan for ``[0, n)`` — same seed, same chaos.
        """
        if p_drop + p_dup + p_reorder + p_delay > 1.0:
            raise ValueError("link fault probabilities must sum to <= 1")
        rng = random.Random(seed)
        specs = []
        for i in range(n_sends):
            r = rng.random()
            d = rng.uniform(*delay_range)
            hold = rng.uniform(*reorder_hold)
            if r < p_drop:
                specs.append(LinkFault(DROP, i))
            elif r < p_drop + p_dup:
                specs.append(LinkFault(DUPLICATE, i, copies=copies))
            elif r < p_drop + p_dup + p_reorder:
                specs.append(LinkFault(REORDER, i, delay=hold))
            elif r < p_drop + p_dup + p_reorder + p_delay:
                specs.append(LinkFault(LINK_DELAY, i, delay=d))
        return cls(tuple(specs))


class SimLink:
    """The in-memory wire: ``send`` schedules each surviving copy of a
    datagram onto the loop at ``now + latency + fault delay``. Control
    traffic (HELLO/FIN/CREDIT) rides ``chaos=False`` — the handshake is
    assumed reliable, which keeps the chaos surface exactly the frame
    path the reorder machinery must survive."""

    def __init__(self, loop, deliver: Callable[[bytes], None],
                 plan: Optional[LinkPlan] = None, latency: float = 0.0):
        self.loop = loop
        self.deliver = deliver
        self.plan = plan
        self.latency = latency
        self.sends = 0          # chaos-eligible datagrams offered
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.delayed = 0

    def send(self, data: bytes, chaos: bool = True) -> None:
        prio = getattr(self.loop, "PRIO_ARRIVAL", 0)
        if not chaos or self.plan is None:
            arrivals = [0.0]
        else:
            index = self.sends
            self.sends += 1
            arrivals = self.plan.arrivals(index)
            spec = self.plan.for_send(index)
            if spec is not None:
                if spec.kind == DROP:
                    self.dropped += 1
                elif spec.kind == DUPLICATE:
                    self.duplicated += 1
                elif spec.kind == REORDER:
                    self.reordered += 1
                elif spec.kind == LINK_DELAY:
                    self.delayed += 1
        for extra in arrivals:
            self.loop.schedule(
                self.loop.now + self.latency + extra,
                lambda data=data: self.deliver(data),
                priority=prio,
            )


# ---------------------------------------------------------------------------
# Client: TransportSource
# ---------------------------------------------------------------------------

class TransportSource:
    """Client half of the transport: paces a ``FrameSource``'s plan onto
    the wire, keeps a bounded retransmit buffer, and obeys the server's
    credit messages.

    The pacing actuator is DUTY: the source's plan was generated at
    ``plan_duty`` (``BurstSource.duty``; 1.0 for other sources), and the
    client stretches inter-frame gaps by ``duty / plan_duty``. A credit
    downshift raises ``duty`` toward 1.0 — the stream spreads the same
    frame budget back toward its admitted rate, which is exactly the
    graceful degradation the server-side shedder could only approximate
    by dropping. ``flow_control=False`` ignores credit entirely (the
    benchmark's control arm)."""

    def __init__(
        self,
        source: FrameSource,
        category: Category,
        relative_deadline: float,
        link,
        flow_control: bool = True,
        retransmit_window: int = 256,
        hello_max_retries: int = 12,
        abort_after: Optional[int] = None,
    ):
        self.source = source
        self.category = category
        self.relative_deadline = relative_deadline
        self.link = link
        self.loop = link.loop
        self.flow_control = flow_control
        self.retransmit_window = retransmit_window
        self.hello_max_retries = hello_max_retries
        # Zombie-client knob (tests/benchmarks): stop sending after this
        # many frames, silently — no FIN, no further traffic. The
        # server's idle-timeout eviction is the only way the session
        # ever resolves.
        self.abort_after = abort_after
        self.plan = source.plan()
        self.plan_duty = float(getattr(source, "duty", 1.0))
        self.duty = self.plan_duty
        self.sid: Optional[int] = None
        self.state = "idle"  # idle | retrying | active | rejected | done | aborted
        self.frames_sent = 0
        self.retransmits = 0
        self.credits_seen = 0
        self.downshifts_applied = 0
        self.rehomes_seen = 0
        self.hello_retries = 0
        self._cursor = 0
        self._sent: Dict[int, np.ndarray] = {}  # seq -> payload (bounded)
        self._server: Optional["TransportServer"] = None
        self._start_in = 0.0

    # -- lifecycle ------------------------------------------------------
    def start(self, server: "TransportServer", start_in: float = 0.0) -> bool:
        """Open the session through the server's HELLO gate (reliable
        control path) and begin sending. Under churn gating the server
        may answer HELLO_RETRY: the client re-HELLOs after the signaled
        backoff (state ``retrying``) instead of failing admission, so a
        registration storm degrades to delayed admission. Returns False
        only on outright rejection (admission refused, or the retry
        budget exhausted)."""
        self._server = server
        self._start_in = start_in
        return self._hello()

    def _hello(self) -> bool:
        mtype, body = decode(
            self._server.hello(
                {
                    "model_id": self.category.model_id,
                    "shape_key": list(self.category.shape_key),
                    "realtime": self.category.realtime,
                    "period": self.source.period,
                    "n_frames": self.source.n_frames,
                    "relative_deadline": self.relative_deadline,
                    "duty": self.plan_duty,
                },
                control=self.control,
            )
        )
        if mtype == HELLO_RETRY:
            self.hello_retries += 1
            if self.hello_retries > self.hello_max_retries:
                self.state = "rejected"
                return False
            self.state = "retrying"
            self.loop.schedule(
                self.loop.now + max(1e-4, float(body.get("backoff", 0.05))),
                self._hello,
                priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
            )
            return True
        self.sid = int(body["sid"])
        if not bool(body.get("accepted")):
            self.state = "rejected"
            return False
        self.state = "active"
        self.loop.schedule(
            self.loop.now + self._start_in + self.plan[0].offset,
            self._send_next,
            priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
        )
        return True

    def start_remote(self, sid: int, start_in: float = 0.0) -> None:
        """Begin sending against a session opened out-of-band (the UDP
        binding's HELLO/HELLO_ACK handshake yields the sid)."""
        self.sid = sid
        self.state = "active"
        self.loop.schedule(
            self.loop.now + start_in + self.plan[0].offset,
            self._send_next,
            priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
        )

    # -- send path ------------------------------------------------------
    def _remember(self, seq: int, payload: np.ndarray) -> None:
        self._sent[seq] = payload
        while len(self._sent) > self.retransmit_window:
            self._sent.pop(min(self._sent))

    def _send_next(self) -> None:
        if self.state != "active":
            return
        k = self._cursor
        if self.abort_after is not None and k >= self.abort_after:
            # Zombie: vanish mid-stream without a FIN. The server must
            # eventually evict us or leak the session forever.
            self.state = "aborted"
            return
        payload = self.plan[k].payload
        self._remember(k, payload)
        self.frames_sent += 1
        self.link.send(encode_data(self.sid, k, self.loop.now, payload))
        self._cursor += 1
        if self._cursor < len(self.plan):
            gap = self.plan[self._cursor].offset - self.plan[k].offset
            pace = self.duty / self.plan_duty
            self.loop.schedule(
                self.loop.now + max(0.0, gap) * pace,
                self._send_next,
                priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
            )
            return
        self.state = "done"
        self.link.send(
            encode_control(FIN, {"sid": self.sid, "total": len(self.plan)}),
            chaos=False,
        )

    # -- control path (server -> client) --------------------------------
    def control(self, data: bytes) -> None:
        mtype, body = decode(data)
        if mtype == MALFORMED:
            return  # a chaotic wire can corrupt control datagrams too
        try:
            if mtype == CREDIT:
                self.credits_seen += 1
                if not self.flow_control:
                    return  # control arm: the client never downshifts
                new = min(1.0, max(self.plan_duty, float(body["duty"])))
                if new > self.duty:
                    self.downshifts_applied += 1
                self.duty = new
            elif mtype == REHOME:
                self.rehomes_seen += 1
                self._retransmit(int(body["from_seq"]))
        except (KeyError, TypeError, ValueError):
            return  # missing/mistyped body field: drop, don't crash

    def _retransmit(self, from_seq: int) -> None:
        """Replay the unresolved window from the retransmit buffer. The
        retries traverse the SAME chaotic wire — the link does not know
        they are retries, so a retransmit can itself be dropped (the
        bit-exactness property is over frames that survive)."""
        for seq in sorted(s for s in self._sent if s >= from_seq):
            self.retransmits += 1
            self.link.send(
                encode_data(self.sid, seq, self.loop.now, self._sent[seq])
            )


# ---------------------------------------------------------------------------
# Server: TransportServer
# ---------------------------------------------------------------------------

class _ShardedSessionTable:
    """Session table split over power-of-2 shards.

    Per-datagram dispatch is one hash either way; sharding buys bounded
    *background* work — the lifecycle sweep visits one shard per tick,
    so its per-tick cost is ``O(sessions / n_shards)`` instead of a
    full-table scan that would stall the rx path at thousands of
    sessions. The surface mimics ``dict`` so existing callers
    (``server.sessions[sid]``, ``.values()``, ``len``) keep working.
    """

    __slots__ = ("_shards", "_mask", "_len")

    def __init__(self, n_shards: int = 16) -> None:
        n = 1
        while n < max(1, n_shards):
            n <<= 1
        self._shards: List[Dict[int, "TransportSession"]] = [
            {} for _ in range(n)
        ]
        self._mask = n - 1
        self._len = 0

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    def shard(self, index: int) -> Dict[int, "TransportSession"]:
        return self._shards[index & self._mask]

    def __getitem__(self, sid: int) -> "TransportSession":
        return self._shards[sid & self._mask][sid]

    def __setitem__(self, sid: int, ts: "TransportSession") -> None:
        shard = self._shards[sid & self._mask]
        if sid not in shard:
            self._len += 1
        shard[sid] = ts

    def __delitem__(self, sid: int) -> None:
        del self._shards[sid & self._mask][sid]
        self._len -= 1

    def __contains__(self, sid: int) -> bool:
        return sid in self._shards[sid & self._mask]

    def __len__(self) -> int:
        return self._len

    def __iter__(self):
        for shard in self._shards:
            yield from shard

    def get(self, sid: int, default=None):
        return self._shards[sid & self._mask].get(sid, default)

    def pop(self, sid: int, *default):
        shard = self._shards[sid & self._mask]
        if sid in shard:
            self._len -= 1
            return shard.pop(sid)
        if default:
            return default[0]
        raise KeyError(sid)

    def keys(self):
        return list(self)

    def values(self):
        for shard in self._shards:
            yield from shard.values()

    def items(self):
        for shard in self._shards:
            yield from shard.items()


@dataclass
class TransportSession:
    """Server-side wire state for one session; the admission/shedding
    state lives on the wrapped gateway ``StreamSession``."""

    sid: int
    session: StreamSession
    n_frames: int
    relative_deadline: float
    plan_duty: float
    duty: float
    control: Optional[Callable[[bytes], None]] = None
    next_seq: int = 0  # first seq not yet resolved in order
    buffer: Dict[int, Tuple[np.ndarray, float]] = field(default_factory=dict)
    seen: Set[int] = field(default_factory=set)  # resolved seqs
    # Wire accounting: every DATA datagram lands in exactly one bucket.
    wire_received: int = 0
    duplicates: int = 0
    late_rejected: int = 0
    net_lost: int = 0        # declared lost at a reorder-gap skip / finalize
    delivered: int = 0
    shed: int = 0
    lost_to_slice: int = 0   # delivered into a just-closed device
    refused: int = 0         # arrived for a closed/rejected session, or
                             # bounced off a reassembly byte budget
    evicted: int = 0         # buffered frames discarded by lifecycle
                             # eviction / expiry / FIN-truncation
    rehomes: int = 0
    fin_total: Optional[int] = None
    finalized: bool = False
    eviction_reason: Optional[str] = None
    last_credit_at: float = -math.inf
    cohort_downshifts: int = 0
    buffered_bytes: int = 0
    opened_at: float = 0.0
    last_activity: float = 0.0
    open_counted: bool = False
    delivered_log: List[int] = field(default_factory=list)
    delivered_payloads: Dict[int, np.ndarray] = field(default_factory=dict)

    def wire_conserved(self) -> bool:
        """Every datagram that reached the server is accounted: resolved
        (one way), suppressed as a duplicate, still buffered, refused,
        or evicted with its session."""
        resolved = (
            self.delivered + self.shed + self.late_rejected + self.lost_to_slice
        )
        return self.wire_received == (
            resolved
            + self.duplicates
            + len(self.buffer)
            + self.refused
            + self.evicted
        )


class TransportServer:
    """Receive half: reassembly, flow control, re-homing, observability.

    Sits in front of an :class:`IngestGateway` (over a single ``DeepRT``
    or a ``ClusterScheduler``). With a cluster target it registers
    itself as the rehome owner (``ClusterScheduler.set_rehome_owner``)
    and subscribes to the health monitor, so ``fail_slice`` re-admits
    transport-owned tails as EXTERNAL requests and hands them back here
    instead of streaming synthetic zeros.
    """

    def __init__(
        self,
        gateway: IngestGateway,
        flow_control: bool = True,
        reorder_window: int = 8,
        reorder_timeout: Optional[float] = None,
        late_reject_factor: float = 1.0,
        duty_step: float = 1.5,
        high_water: float = 1.0,
        low_water: float = 0.25,
        credit_min_interval: float = 0.0,
        record_payloads: bool = False,
        reassembly_budget_bytes: Optional[int] = None,
        session_buffer_bytes: Optional[int] = None,
        idle_timeout: Optional[float] = None,
        hello_rate: Optional[float] = None,
        hello_burst: float = 8.0,
        max_sessions: Optional[int] = None,
        retain_finalized: bool = True,
        shards: int = 16,
    ):
        self.gateway = gateway
        self.loop = gateway.loop
        self.flow_control = flow_control
        self.reorder_window = reorder_window
        self.reorder_timeout = reorder_timeout
        self.late_reject_factor = late_reject_factor
        self.duty_step = duty_step
        self.high_water = high_water
        self.low_water = low_water
        self.credit_min_interval = credit_min_interval
        self.record_payloads = record_payloads
        # Resource-lifecycle bounds. All default OFF (None) so the
        # pre-hardening behavior — unbounded buffers, immortal sessions,
        # ungated HELLO — is what small tests get without opting in.
        self.reassembly_budget_bytes = reassembly_budget_bytes
        self.session_buffer_bytes = session_buffer_bytes
        self.idle_timeout = idle_timeout
        self.hello_rate = hello_rate
        self.hello_burst = float(hello_burst)
        self.max_sessions = max_sessions
        self.retain_finalized = retain_finalized
        self.sessions = _ShardedSessionTable(shards)
        self._by_rid: Dict[int, TransportSession] = {}
        self._sids = itertools.count(1)
        self._cohort: Dict[str, Set[int]] = {}  # slice name -> open sids
        # HELLO token bucket (lazy refill against loop.now).
        self._hello_tokens = self.hello_burst
        self._hello_tokens_at = self.loop.now
        # Lifecycle counters (all surfaced via telemetry()).
        self.open_count = 0
        self.draining = False
        self.drained = False
        self.reassembly_bytes = 0
        self.reassembly_peak_bytes = 0
        self.budget_refusals = 0
        self.evictions = 0
        self.retired_sessions = 0
        self.retired_totals: Dict[str, int] = {
            "wire_received": 0, "delivered": 0, "shed": 0,
            "late_rejected": 0, "lost_to_slice": 0, "duplicates": 0,
            "refused": 0, "evicted": 0, "net_lost": 0,
        }
        self.malformed = 0
        self.malformed_by_reason: Dict[str, int] = {}
        self.hellos_seen = 0
        self.hellos_accepted = 0
        self.hellos_rejected = 0
        self.hello_retries_sent = 0
        self.hello_refused_draining = 0
        self.cohort_signals = 0
        self._sweep_armed = False
        self._sweep_shard = 0
        # Frame-lifecycle tracer (core/telemetry.py); None = off. The
        # transport is where wire receive / reassembly / wire-loss hops
        # are stamped (the only component that sees them).
        self.tracer = None
        self.health_log: List[Tuple[float, str, str, str]] = []
        target = gateway.target
        if hasattr(target, "set_rehome_owner"):
            target.set_rehome_owner(self)
        health = getattr(target, "health", None)
        if health is not None:
            health.subscribe(self._on_health)
        probes = getattr(target, "telemetry_probes", None)
        if probes is not None:
            probes["transport"] = self.telemetry

    # -- adversarial-wire accounting ------------------------------------
    def note_malformed(self, reason) -> None:
        """Count a datagram that failed to decode (or a control body
        that failed validation). Reasons come from :func:`decode`."""
        self.malformed += 1
        key = str(reason)
        self.malformed_by_reason[key] = (
            self.malformed_by_reason.get(key, 0) + 1
        )

    # -- HELLO gate ------------------------------------------------------
    def hello(
        self, body: Dict, control: Optional[Callable[[bytes], None]] = None
    ) -> bytes:
        """Admission front door for a HELLO body; returns the encoded
        reply datagram (HELLO_ACK, or HELLO_RETRY under churn gating).

        Order of the gates matters: draining wins over everything (a
        retry against a draining server would loop forever), then the
        token bucket and the open-session cap answer HELLO_RETRY —
        *transient* refusals a client can wait out — and only a HELLO
        that passes the gates spends a Phase-1 admission test."""
        self.hellos_seen += 1
        if self.draining:
            self.hello_refused_draining += 1
            return encode_control(
                HELLO_ACK, {"sid": 0, "accepted": False, "reason": "draining"}
            )
        try:
            category = Category(
                model_id=str(body["model_id"]),
                shape_key=tuple(int(x) for x in body["shape_key"]),
                realtime=bool(body.get("realtime", True)),
            )
            period = float(body["period"])
            n_frames = int(body["n_frames"])
            relative_deadline = float(body["relative_deadline"])
            duty = float(body.get("duty", 1.0))
            if period <= 0 or n_frames <= 0 or relative_deadline <= 0:
                raise ValueError("non-positive stream parameter")
        except Exception:
            self.note_malformed("bad_hello_body")
            return encode_control(
                HELLO_ACK, {"sid": 0, "accepted": False, "reason": "bad_body"}
            )
        if self.hello_rate is not None:
            now = self.loop.now
            self._hello_tokens = min(
                self.hello_burst,
                self._hello_tokens
                + (now - self._hello_tokens_at) * self.hello_rate,
            )
            self._hello_tokens_at = now
            if self._hello_tokens < 1.0:
                self.hello_retries_sent += 1
                backoff = (1.0 - self._hello_tokens) / self.hello_rate
                return encode_control(HELLO_RETRY, {"backoff": backoff})
            self._hello_tokens -= 1.0
        if self.max_sessions is not None and self.open_count >= self.max_sessions:
            self.hello_retries_sent += 1
            return encode_control(
                HELLO_RETRY,
                {"backoff": self.idle_timeout or 0.1, "reason": "at_capacity"},
            )
        sid, ok = self.open_session(
            category=category, period=period, n_frames=n_frames,
            relative_deadline=relative_deadline, duty=duty, control=control,
        )
        if ok:
            self.hellos_accepted += 1
        else:
            self.hellos_rejected += 1
        return encode_control(HELLO_ACK, {"sid": sid, "accepted": ok})

    # -- session lifecycle ----------------------------------------------
    def open_session(
        self,
        category: Category,
        period: float,
        n_frames: int,
        relative_deadline: float,
        duty: float = 1.0,
        control: Optional[Callable[[bytes], None]] = None,
        start_in: float = 0.0,
    ) -> Tuple[int, bool]:
        """Admission-test the declared stream through the gateway's
        normal placement/admission/lease path; the transport owns the
        frame path (``schedule_arrivals=False``)."""
        declared = PeriodicSource(period=period, n_frames=n_frames)
        session = self.gateway.register(
            declared, category, relative_deadline,
            start_in=start_in, schedule_arrivals=False,
        )
        sid = next(self._sids)
        now = self.loop.now
        ts = TransportSession(
            sid=sid, session=session, n_frames=n_frames,
            relative_deadline=relative_deadline,
            plan_duty=float(duty), duty=float(duty), control=control,
            opened_at=now, last_activity=now,
        )
        self.sessions[sid] = ts
        if session.state != "active":
            ts.finalized = True
            if not self.retain_finalized:
                self._retire(ts)
            return sid, False
        self._by_rid[session.request_id] = ts
        ts.open_counted = True
        self.open_count += 1
        if session.slice_name is not None:
            self._cohort.setdefault(session.slice_name, set()).add(sid)
        self._arm_sweep()
        return sid, True

    # -- datagram entry --------------------------------------------------
    def datagram(self, data: bytes) -> None:
        mtype, msg = decode(data)
        if mtype == MALFORMED:
            self.note_malformed(msg)
            return
        if mtype == DATA:
            self._on_data(msg)
        elif mtype == FIN:
            try:
                sid, total = int(msg["sid"]), int(msg["total"])
            except (KeyError, TypeError, ValueError):
                self.note_malformed("bad_fin_body")
                return
            self._on_fin(sid, total)
        # HELLO/STATUS are handled by the socket binding (control path).

    # -- bounded reassembly ----------------------------------------------
    @staticmethod
    def _nbytes(payload) -> int:
        return int(getattr(payload, "nbytes", 4))

    def _buffer_put(
        self, ts: TransportSession, seq: int, payload, at: float
    ) -> bool:
        """Admit a frame to the reorder buffer iff it fits both the
        per-session and the global byte budget; a refused frame is a
        counted ``refused`` (its gap resolves as net_lost later, so each
        datagram still lands in exactly one conservation leg)."""
        nb = self._nbytes(payload)
        if (
            self.session_buffer_bytes is not None
            and ts.buffered_bytes + nb > self.session_buffer_bytes
        ) or (
            self.reassembly_budget_bytes is not None
            and self.reassembly_bytes + nb > self.reassembly_budget_bytes
        ):
            ts.refused += 1
            self.budget_refusals += 1
            return False
        ts.buffer[seq] = (payload, at)
        ts.buffered_bytes += nb
        self.reassembly_bytes += nb
        if self.reassembly_bytes > self.reassembly_peak_bytes:
            self.reassembly_peak_bytes = self.reassembly_bytes
        return True

    def _buffer_pop(self, ts: TransportSession, seq: int):
        payload, at = ts.buffer.pop(seq)
        nb = self._nbytes(payload)
        ts.buffered_bytes -= nb
        self.reassembly_bytes -= nb
        return payload, at

    def _buffer_clear(self, ts: TransportSession) -> int:
        """Discard the whole reorder buffer; returns the frame count so
        the caller can pick the conservation leg (``evicted``)."""
        n = len(ts.buffer)
        ts.buffer.clear()
        self.reassembly_bytes -= ts.buffered_bytes
        ts.buffered_bytes = 0
        return n

    def _on_data(self, msg: DataMsg) -> None:
        ts = self.sessions.get(msg.session_id)
        if ts is None:
            return
        ts.wire_received += 1
        ts.last_activity = self.loop.now
        state = ts.session.state
        if ts.finalized or state in ("closed", "rejected"):
            ts.refused += 1
            return
        if msg.seq in ts.seen or msg.seq in ts.buffer:
            ts.duplicates += 1
            return
        now = self.loop.now
        if self.tracer is not None:
            # Stamps both the receive hop and (via meta["sent_at"]) the
            # sender-clock send hop for this frame's wire-stage delta.
            self.tracer.emit(
                T.WIRE_RECV, now, ts.session.request_id, msg.seq,
                where=ts.session.slice_name,
                cat=str(ts.session.request.category),
                meta={"sent_at": msg.sent_at})
        if now - msg.sent_at > self.late_reject_factor * ts.relative_deadline:
            # Older than its whole deadline budget: it would miss even if
            # the device were idle — reject at the door, resolved as a
            # gateway-style drop (counted in ``ingested`` via dropped).
            ts.seen.add(msg.seq)
            ts.late_rejected += 1
            self._account_drop(
                ts, reason=f"late: aged {now - msg.sent_at:.4f}s on the wire",
                seq=msg.seq,
            )
            return
        if state == "failover":
            # Slice died, tail not re-admitted yet (parked): hold the
            # real bytes — they are exactly what re-homing replays.
            self._buffer_put(ts, msg.seq, msg.payload, now)
            return
        if msg.seq == ts.next_seq:
            self._deliver(ts, msg.seq, msg.payload)
            self._drain(ts)
        elif msg.seq > ts.next_seq:
            self._buffer_put(ts, msg.seq, msg.payload, now)
            self._maybe_skip_gap(ts)
            if ts.buffer:
                self.loop.schedule_in(
                    self._timeout(ts),
                    lambda: self._gap_check(ts),
                    priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
                )
        else:
            # Below next_seq but not in ``seen``: the gap was already
            # resolved (declared lost); this copy is a straggler.
            ts.duplicates += 1

    # -- reorder window ---------------------------------------------------
    def _timeout(self, ts: TransportSession) -> float:
        if self.reorder_timeout is not None:
            return self.reorder_timeout
        return ts.relative_deadline

    def _gap_check(self, ts: TransportSession) -> None:
        if ts.finalized or ts.session.state != "active":
            return
        self._maybe_skip_gap(ts)

    def _maybe_skip_gap(self, ts: TransportSession) -> None:
        """Bounded reorder window: once the buffer exceeds the window or
        its oldest entry exceeds the timeout, the missing gap seqs are
        declared lost and the buffered tail drains in order."""
        now = self.loop.now
        while ts.buffer:
            oldest = min(at for _p, at in ts.buffer.values())
            if (len(ts.buffer) <= self.reorder_window
                    and now - oldest < self._timeout(ts)):
                return
            lo = min(ts.buffer)
            for seq in range(ts.next_seq, lo):
                self._account_lost(ts, seq)
            ts.next_seq = lo
            self._drain(ts)

    def _drain(self, ts: TransportSession) -> None:
        while ts.next_seq in ts.buffer:
            payload, _at = self._buffer_pop(ts, ts.next_seq)
            self._deliver(ts, ts.next_seq, payload)

    # -- resolution paths --------------------------------------------------
    def _deliver(self, ts: TransportSession, seq: int, payload) -> None:
        ts.seen.add(seq)
        ts.next_seq = max(ts.next_seq, seq + 1)
        if self.tracer is not None:
            self.tracer.emit(
                T.REASSEMBLY, self.loop.now, ts.session.request_id, seq,
                where=ts.session.slice_name,
                cat=str(ts.session.request.category))
        status = self.gateway.deliver(ts.session, seq, payload)
        if status == "delivered":
            ts.delivered += 1
            ts.delivered_log.append(seq)
            if self.record_payloads:
                ts.delivered_payloads[seq] = np.array(payload, copy=True)
        elif status == "shed":
            ts.shed += 1
        elif status == "lost":
            ts.lost_to_slice += 1
        else:  # refused: session flipped state under us
            ts.refused += 1
        if status in ("delivered", "shed"):
            self._flow_control(ts)

    def _account_drop(
        self, ts: TransportSession, reason: str, seq: int = -1
    ) -> None:
        """Resolve a wire frame as DROPPED at the gateway boundary (the
        bytes arrived; they are rejected, not vanished)."""
        session = ts.session
        session.frames_ingested += 1
        session.frames_dropped += 1
        session.last_shed_reason = reason
        sched = self.gateway._scheduler_of(session)
        sched.metrics.record_drop(session.request_id)
        sl = self.gateway._slice_of(session)
        if sl is not None:
            sl.note_dropped(session.request_id)
        if self.tracer is not None:
            self.tracer.emit(
                T.SHED, self.loop.now, session.request_id, seq,
                where=session.slice_name,
                cat=str(session.request.category),
                meta={"reason": reason})

    def _account_lost(self, ts: TransportSession, seq: int) -> None:
        """Resolve a wire frame the link destroyed as LOST: counted
        ingested AND lost (the closed-device convention), so the
        conservation identity covers frames that never arrived."""
        ts.seen.add(seq)
        ts.net_lost += 1
        session = ts.session
        session.frames_lost += 1
        sched = self.gateway._scheduler_of(session)
        sched.metrics.record_ingest()
        sched.metrics.record_lost()
        sl = self.gateway._slice_of(session)
        if sl is not None:
            sl.note_dropped(session.request_id)
        if self.tracer is not None:
            self.tracer.emit(
                T.LOST, self.loop.now, session.request_id, seq,
                where=session.slice_name,
                cat=str(session.request.category),
                meta={"reason": "wire"})

    # -- flow control ------------------------------------------------------
    def _flow_control(self, ts: TransportSession) -> None:
        if not self.flow_control or ts.control is None:
            return
        session = ts.session
        delay, budget = self.gateway.delay_estimate(session)
        now = self.loop.now
        if now - ts.last_credit_at < self.credit_min_interval:
            return
        new = ts.duty
        reason = None
        if (delay > self.high_water * budget or math.isinf(delay)) and ts.duty < 1.0:
            new = min(1.0, ts.duty * self.duty_step)
            reason = (
                f"over_budget: predicted {delay:.4f}s > "
                f"{self.high_water:.2f}x budget {budget:.4f}s"
            )
        elif delay < self.low_water * budget and ts.duty > ts.plan_duty:
            new = max(ts.plan_duty, ts.duty / self.duty_step)
        if new == ts.duty:
            return
        ts.duty = new
        ts.last_credit_at = now
        session.credit = ts.plan_duty / new
        if reason is not None:
            session.downshifts += 1
            session.last_downshift_reason = reason
        ts.control(
            encode_control(CREDIT, {"sid": ts.sid, "duty": new, "reason": reason})
        )

    # -- re-homing (ClusterScheduler rehome-owner protocol) ----------------
    def owns(self, request_id: int) -> bool:
        return request_id in self._by_rid

    def rehomed(self, origin_rid: int, tail, slice_name: str) -> None:
        """``fail_slice`` re-admitted this session's tail as an external
        request on ``slice_name``: rebind the session, drain the real
        buffered bytes into the new slice, ask the client to retransmit
        the unresolved window."""
        ts = self._by_rid.pop(origin_rid)
        session = ts.session
        session.request = tail
        old_slice = session.slice_name
        if old_slice is not None:
            self._cohort.get(old_slice, set()).discard(ts.sid)
        session.slice_name = slice_name
        self._cohort.setdefault(slice_name, set()).add(ts.sid)
        session.state = "active"
        session.rehomes += 1
        ts.rehomes += 1
        self._by_rid[tail.request_id] = ts
        self._drain(ts)
        if ts.control is not None:
            ts.control(
                encode_control(
                    REHOME,
                    {"sid": ts.sid, "from_seq": ts.next_seq,
                     "slice": slice_name},
                )
            )

    def expired(self, origin_rid: int) -> None:
        """The parked tail provably expired: the session is over; held
        bytes with nowhere to go are evicted with it."""
        ts = self._by_rid.pop(origin_rid, None)
        if ts is None:
            return
        ts.session.state = "closed"
        ts.finalized = True
        ts.eviction_reason = "tail_expired"
        ts.evicted += self._buffer_clear(ts)
        self._session_done(ts)

    def _on_health(self, name: str, old: str, new: str) -> None:
        self.health_log.append((self.loop.now, name, old, new))
        # Cohort credit aggregation: one degradation event fans ONE
        # CREDIT downshift to every open session homed on the slice,
        # instead of waiting for each session's own delay estimate to
        # trickle over the high-water mark.
        if new == "suspect":
            self._cohort_downshift(name)

    def _cohort_downshift(self, slice_name: str) -> None:
        for sid in sorted(self._cohort.get(slice_name, ())):
            ts = self.sessions.get(sid)
            if ts is None or ts.finalized or ts.control is None:
                continue
            new_duty = min(1.0, ts.duty * self.duty_step)
            if new_duty == ts.duty:
                continue  # already paced at full period
            ts.duty = new_duty
            ts.last_credit_at = self.loop.now
            ts.cohort_downshifts += 1
            session = ts.session
            session.credit = ts.plan_duty / new_duty
            session.downshifts += 1
            session.last_downshift_reason = (
                f"cohort: slice {slice_name} degraded"
            )
            self.cohort_signals += 1
            ts.control(
                encode_control(
                    CREDIT,
                    {"sid": ts.sid, "duty": new_duty,
                     "reason": session.last_downshift_reason},
                )
            )

    # -- session lifecycle enforcement ------------------------------------
    def _arm_sweep(self) -> None:
        """Idle/zombie sweep: visits ONE shard per tick (bounded work),
        cycling the whole table once per ``idle_timeout``. Self-disarms
        when no session is open so a virtual-time ``EventLoop.run()``
        still terminates."""
        if self.idle_timeout is None or self._sweep_armed:
            return
        if self.open_count <= 0:
            return
        self._sweep_armed = True
        interval = self.idle_timeout / self.sessions.n_shards
        self.loop.schedule_in(
            interval, self._lifecycle_tick,
            priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
        )

    def _lifecycle_tick(self) -> None:
        self._sweep_armed = False
        if self.idle_timeout is None:
            return
        shard = self.sessions.shard(self._sweep_shard)
        self._sweep_shard = (self._sweep_shard + 1) % self.sessions.n_shards
        now = self.loop.now
        for ts in list(shard.values()):
            if ts.finalized or ts.session.state == "failover":
                continue
            if now - ts.last_activity > self.idle_timeout:
                reason = (
                    "zombie_idle" if ts.fin_total is None else "fin_timeout"
                )
                self._evict(ts, reason)
        self._arm_sweep()

    def _evict(self, ts: TransportSession, reason: str) -> None:
        """Forcibly retire a session: discard its reorder buffer into
        the ``evicted`` leg and close the gateway session through the
        NORMAL close path, which releases the arena-row lease and
        retires the request from the DisBatcher — so the scheduler
        identity ``completed + dropped + lost == ingested`` holds no
        matter when the eviction lands."""
        if ts.finalized:
            return
        ts.finalized = True
        ts.eviction_reason = reason
        ts.evicted += self._buffer_clear(ts)
        self.evictions += 1
        self._by_rid.pop(ts.session.request_id, None)
        self.gateway.close(ts.session)
        self._session_done(ts)

    def _session_done(self, ts: TransportSession) -> None:
        """Bookkeeping shared by every terminal path (finalize, evict,
        expire): decrement the open count exactly once, leave the
        cohort, and — under ``retain_finalized=False`` — fold the
        session's wire legs into ``retired_totals`` and drop it."""
        if ts.open_counted:
            ts.open_counted = False
            self.open_count -= 1
        slice_name = ts.session.slice_name
        if slice_name is not None:
            self._cohort.get(slice_name, set()).discard(ts.sid)
        if not self.retain_finalized:
            self._retire(ts)

    def _retire(self, ts: TransportSession) -> None:
        if not ts.wire_conserved():
            raise AssertionError(
                f"session {ts.sid} retiring unconserved: "
                f"received={ts.wire_received} delivered={ts.delivered} "
                f"shed={ts.shed} late={ts.late_rejected} "
                f"lost_to_slice={ts.lost_to_slice} dup={ts.duplicates} "
                f"buffered={len(ts.buffer)} refused={ts.refused} "
                f"evicted={ts.evicted}"
            )
        t = self.retired_totals
        t["wire_received"] += ts.wire_received
        t["delivered"] += ts.delivered
        t["shed"] += ts.shed
        t["late_rejected"] += ts.late_rejected
        t["lost_to_slice"] += ts.lost_to_slice
        t["duplicates"] += ts.duplicates
        t["refused"] += ts.refused
        t["evicted"] += ts.evicted
        t["net_lost"] += ts.net_lost
        self.retired_sessions += 1
        self.sessions.pop(ts.sid, None)

    # -- stream completion -------------------------------------------------
    def _on_fin(self, sid: int, total: int) -> None:
        ts = self.sessions.get(sid)
        if ts is None or ts.finalized:
            return
        ts.fin_total = total
        self.loop.schedule_in(
            self._timeout(ts),
            lambda: self._finalize(ts),
            priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
        )

    def _finalize(self, ts: TransportSession) -> None:
        if ts.finalized:
            return
        if ts.session.state == "failover":
            # Tail still parked: re-homing or expiry resolves it in
            # bounded time; check again after another grace window.
            self.loop.schedule_in(
                self._timeout(ts),
                lambda: self._finalize(ts),
                priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
            )
            return
        ts.finalized = True
        session = ts.session
        total = ts.fin_total if ts.fin_total is not None else ts.n_frames
        if session.state == "active":
            for seq in range(ts.next_seq, total):
                if seq in ts.buffer:
                    payload, _at = self._buffer_pop(ts, seq)
                    self._deliver(ts, seq, payload)
                else:
                    self._account_lost(ts, seq)
        # Remnants past the FIN total (an adversarial FIN can understate
        # it) are evicted, not vanished — wire_conserved() must hold.
        ts.evicted += self._buffer_clear(ts)
        sl = self.gateway._slice_of(session)
        if sl is not None:
            # Period-arithmetic tails can leave a residual lease count;
            # the stream is over, so the arena row frees now.
            sl.release(session.request_id)
        if session.state == "active":
            sched = self.gateway._scheduler_of(session)
            sched.disbatcher.remove_request(session.request)
            session.state = "closed"
        self._session_done(ts)

    def finalize_all(self) -> None:
        """Resolve every open session's tail (benchmark/test epilogue for
        runs whose FIN was consumed by the chaos plan or never sent)."""
        for ts in list(self.sessions.values()):
            self._finalize(ts)

    # -- graceful drain ----------------------------------------------------
    def drain(self, grace: Optional[float] = None) -> None:
        """Stop taking new sessions and wind the server down: new HELLOs
        are refused immediately (``accepted: False, reason: draining``),
        in-flight frames keep flowing for one grace window (default: the
        longest reorder timeout any open session could still need), then
        every open session is finalized and conservation is asserted."""
        self.draining = True
        if grace is None:
            grace = 0.0
            for ts in self.sessions.values():
                if not ts.finalized:
                    grace = max(grace, self._timeout(ts))
        self.loop.schedule_in(
            grace, self._drain_finish,
            priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
        )

    def _drain_finish(self) -> None:
        self.finalize_all()
        for ts in self.sessions.values():
            if not ts.wire_conserved():
                raise AssertionError(
                    f"drain left session {ts.sid} unconserved"
                )
        self.drained = True

    def assert_conserved(self) -> None:
        """Prove both conservation identities at quiescence: every wire
        datagram in exactly one leg (live sessions + retired fold), and
        the scheduler identity ``completed + dropped + lost ==
        ingested`` on the target. Call after the loop has run dry."""
        for ts in self.sessions.values():
            if not ts.wire_conserved():
                raise AssertionError(f"session {ts.sid} unconserved")
        t = self.retired_totals
        resolved = (
            t["delivered"] + t["shed"] + t["late_rejected"]
            + t["lost_to_slice"] + t["duplicates"] + t["refused"]
            + t["evicted"]
        )
        if t["wire_received"] != resolved:
            raise AssertionError(
                f"retired fold unconserved: {t['wire_received']} received "
                f"vs {resolved} resolved"
            )
        target = self.gateway.target
        if hasattr(target, "aggregate_metrics"):
            agg = target.aggregate_metrics()
            lhs = (
                agg["completed_frames"] + agg["dropped_frames"]
                + agg["lost_frames"]
            )
            rhs = agg["ingested_frames"]
        else:
            m = target.metrics
            lhs = m.completed_frames + m.dropped_frames + m.lost_frames
            rhs = m.ingested_frames
        if lhs != rhs:
            raise AssertionError(
                f"scheduler identity broken: completed+dropped+lost={lhs} "
                f"!= ingested={rhs}"
            )

    # -- observability (scrapeable JSON snapshot) --------------------------
    def telemetry(self) -> Dict:
        """Bounded (O(1)-sized) lifecycle counter block. Registered as
        the cluster's ``transport`` telemetry probe, and embedded in
        every ``status()`` reply."""
        return {
            "sessions": len(self.sessions),
            "open_sessions": self.open_count,
            "retired_sessions": self.retired_sessions,
            "evictions": self.evictions,
            "draining": self.draining,
            "drained": self.drained,
            "reassembly_bytes": self.reassembly_bytes,
            "reassembly_peak_bytes": self.reassembly_peak_bytes,
            "reassembly_budget_bytes": self.reassembly_budget_bytes,
            "budget_refusals": self.budget_refusals,
            "malformed": self.malformed,
            "malformed_by_reason": dict(self.malformed_by_reason),
            "hellos_seen": self.hellos_seen,
            "hellos_accepted": self.hellos_accepted,
            "hellos_rejected": self.hellos_rejected,
            "hello_retries_sent": self.hello_retries_sent,
            "hello_refused_draining": self.hello_refused_draining,
            "cohort_signals": self.cohort_signals,
            "retired_totals": dict(self.retired_totals),
        }

    def _session_summary(self, top_k: int = 8) -> Dict:
        """Aggregate view that stays bounded at thousands of sessions:
        whole-table counter sums, a state histogram, and only the top-K
        worst sessions (by unresolved/penalty legs) in full detail."""
        agg = {
            "wire_received": 0, "delivered": 0, "shed": 0,
            "late_rejected": 0, "net_lost": 0, "lost_to_slice": 0,
            "duplicates": 0, "buffered": 0, "refused": 0, "evicted": 0,
        }
        states: Dict[str, int] = {}
        violations = 0
        scored: List[Tuple[int, int]] = []
        for sid, ts in self.sessions.items():
            agg["wire_received"] += ts.wire_received
            agg["delivered"] += ts.delivered
            agg["shed"] += ts.shed
            agg["late_rejected"] += ts.late_rejected
            agg["net_lost"] += ts.net_lost
            agg["lost_to_slice"] += ts.lost_to_slice
            agg["duplicates"] += ts.duplicates
            agg["buffered"] += len(ts.buffer)
            agg["refused"] += ts.refused
            agg["evicted"] += ts.evicted
            st = ts.session.state
            states[st] = states.get(st, 0) + 1
            if not ts.wire_conserved():
                violations += 1
            score = (
                ts.net_lost + ts.shed + ts.late_rejected + ts.refused
                + ts.evicted + ts.lost_to_slice
            )
            if score:
                scored.append((score, sid))
        scored.sort(reverse=True)
        worst = {}
        for score, sid in scored[:top_k]:
            ts = self.sessions[sid]
            worst[str(sid)] = {
                "score": score,
                "state": ts.session.state,
                "slice": ts.session.slice_name,
                "eviction_reason": ts.eviction_reason,
                "wire": {
                    "received": ts.wire_received,
                    "delivered": ts.delivered,
                    "shed": ts.shed,
                    "late_rejected": ts.late_rejected,
                    "net_lost": ts.net_lost,
                    "refused": ts.refused,
                    "evicted": ts.evicted,
                },
            }
        return {
            "count": len(self.sessions),
            "states": states,
            "wire_totals": agg,
            "conservation_violations": violations,
            "worst": worst,
        }

    def status(self, summary: bool = False, top_k: int = 8) -> Dict:
        target = self.gateway.target
        out: Dict = {
            "now": self.loop.now,
            "flow_control": self.flow_control,
            "transport": self.telemetry(),
            "health_transitions": [
                {"t": t, "slice": n, "old": o, "new": w}
                for t, n, o, w in self.health_log
            ],
        }
        if summary:
            out["session_summary"] = self._session_summary(top_k)
            return self._status_target(out, target)
        out["sessions"] = {}
        for sid, ts in self.sessions.items():
            s = ts.session
            out["sessions"][str(sid)] = {
                "state": s.state,
                "slice": s.slice_name,
                "request_id": s.request_id,
                "credit": s.credit,
                "duty": ts.duty,
                "rehomes": ts.rehomes,
                "downshifts": s.downshifts,
                "last_downshift_reason": s.last_downshift_reason,
                "last_shed_reason": s.last_shed_reason,
                "gateway": {
                    "ingested": s.frames_ingested,
                    "delivered": s.frames_delivered,
                    "dropped": s.frames_dropped,
                    "lost": s.frames_lost,
                },
                "wire": {
                    "received": ts.wire_received,
                    "delivered": ts.delivered,
                    "shed": ts.shed,
                    "duplicates": ts.duplicates,
                    "late_rejected": ts.late_rejected,
                    "net_lost": ts.net_lost,
                    "lost_to_slice": ts.lost_to_slice,
                    "buffered": len(ts.buffer),
                    "refused": ts.refused,
                    "evicted": ts.evicted,
                    "conserved": ts.wire_conserved(),
                },
            }
        return self._status_target(out, target)

    def _status_target(self, out: Dict, target) -> Dict:
        slices = getattr(target, "slices", None)
        if slices is not None:
            out["slices"] = {}
            for name, sl in slices.items():
                m = sl.scheduler.metrics
                out["slices"][name] = {
                    "health": sl.health,
                    "alive": sl.alive,
                    "utilization": sl.utilization(),
                    "slow_factor": sl.slow_factor,
                    "completed": m.completed_frames,
                    "missed": m.missed_frames,
                    "delivered": m.delivered_frames,
                    "dropped": m.dropped_frames,
                    "lost": m.lost_frames,
                    "duplicate_completions": m.duplicate_completions,
                }
        else:
            m = target.metrics
            out["scheduler"] = {
                "completed": m.completed_frames,
                "missed": m.missed_frames,
                "delivered": m.delivered_frames,
                "dropped": m.dropped_frames,
                "lost": m.lost_frames,
                "duplicate_completions": m.duplicate_completions,
            }
        # Unified telemetry: the cluster's full snapshot (slice health,
        # histograms, probes, miss attribution) rides the same STATUS
        # reply. The embedding is one-way — the snapshot never embeds
        # transport state, so there is no recursion.
        if hasattr(target, "telemetry_snapshot"):
            out["telemetry"] = target.telemetry_snapshot()
        elif self.tracer is not None:
            out["telemetry"] = {
                "tracer": self.tracer.snapshot(),
                "attribution": self.tracer.attribution(),
            }
        return out

    def status_json(self, summary: Optional[bool] = None) -> str:
        """JSON snapshot; ``summary=None`` auto-switches to the bounded
        summary form once the table is large enough that per-session
        detail would blow past a datagram-sized STATUS reply."""
        if summary is None:
            summary = len(self.sessions) > 64
        return json.dumps(self.status(summary=summary), sort_keys=True)


# ---------------------------------------------------------------------------
# Thin real-socket binding (live WallClock path)
# ---------------------------------------------------------------------------

class UdpServerBinding:
    """UDP front door over the same codec: a receive thread forwards
    datagrams onto the loop thread (``WallClock.post``), so the
    TransportServer's state is only ever touched on the loop thread —
    exactly the AsyncDevice completion convention. HELLO opens sessions
    (control replies go back to the sender's address) and a STATUS probe
    returns the scrapeable JSON snapshot."""

    def __init__(self, transport: TransportServer, host: str = "127.0.0.1",
                 port: int = 0):
        if not hasattr(transport.loop, "post"):
            raise ValueError(
                "UdpServerBinding needs a WallClock loop (thread-safe post); "
                "simulated runs use SimLink instead"
            )
        self.transport = transport
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.settimeout(0.1)
        self.addr = self.sock.getsockname()
        self.rx_errors = 0  # dispatch exceptions survived by the rx loop
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._rx, name="drt-udp-server", daemon=True
        )

    def start(self) -> "UdpServerBinding":
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.sock.close()

    def _reply_fn(self, addr) -> Callable[[bytes], None]:
        def _send(data: bytes) -> None:
            try:
                self.sock.sendto(data, addr)
            except OSError:
                pass  # client went away; control traffic is best-effort
        return _send

    def _rx(self) -> None:
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                return
            # The rx thread must be unkillable by wire content: ANY
            # dispatch failure is counted and the loop continues. (A
            # single garbage datagram used to terminate this thread.)
            try:
                self._dispatch(data, addr)
            except Exception:
                self.rx_errors += 1
                self.transport.loop.post(
                    lambda: self.transport.note_malformed("rx_dispatch_error"),
                    priority=getattr(self.transport.loop, "PRIO_ARRIVAL", 0),
                )

    def _dispatch(self, data: bytes, addr) -> None:
        mtype, body = decode(data)
        if mtype == MALFORMED:
            self.transport.loop.post(
                lambda body=body: self.transport.note_malformed(body),
                priority=getattr(self.transport.loop, "PRIO_ARRIVAL", 0),
            )
        elif mtype == HELLO:
            self.transport.loop.post(
                lambda body=body, addr=addr: self._hello(body, addr),
                priority=getattr(self.transport.loop, "PRIO_ARRIVAL", 0),
            )
        elif mtype == STATUS:
            blob = self.transport.status_json().encode()[:60000]
            self._reply_fn(addr)(_HEADER.pack(MAGIC, STATUS_REPLY) + blob)
        else:
            self.transport.loop.post(
                lambda data=data: self.transport.datagram(data),
                priority=getattr(self.transport.loop, "PRIO_ARRIVAL", 0),
            )

    def _hello(self, body: Dict, addr) -> None:
        # All body validation/gating lives in TransportServer.hello();
        # the binding only wires the reply path.
        reply = self._reply_fn(addr)
        reply(self.transport.hello(body, control=reply))


class UdpClientLink:
    """Client-side socket shim exposing the SimLink ``send`` interface
    (chaos is the real network's job here) plus a receive thread that
    forwards server control messages to the TransportSource."""

    def __init__(self, loop, server_addr: Tuple[str, int]):
        if not hasattr(loop, "post"):
            raise ValueError("UdpClientLink needs a WallClock loop")
        self.loop = loop
        self.server_addr = server_addr
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.1)
        self._stop = threading.Event()
        self._source: Optional[TransportSource] = None
        self._hello_reply: Optional[Tuple[int, Dict]] = None  # (mtype, body)
        self._ack_event = threading.Event()
        self._thread = threading.Thread(
            target=self._rx, name="drt-udp-client", daemon=True
        )
        self._thread.start()

    def send(self, data: bytes, chaos: bool = True) -> None:
        try:
            self.sock.sendto(data, self.server_addr)
        except OSError:
            pass

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.sock.close()

    def handshake(self, source: TransportSource, timeout: float = 2.0,
                  retries: int = 3) -> Tuple[Optional[int], bool]:
        """HELLO/HELLO_ACK over the socket (retried: the live wire may
        genuinely drop the handshake)."""
        self._source = source
        body = {
            "model_id": source.category.model_id,
            "shape_key": list(source.category.shape_key),
            "realtime": source.category.realtime,
            "period": source.source.period,
            "n_frames": source.source.n_frames,
            "relative_deadline": source.relative_deadline,
            "duty": source.plan_duty,
        }
        for _ in range(retries):
            self._ack_event.clear()
            self.send(encode_control(HELLO, body), chaos=False)
            if not self._ack_event.wait(timeout):
                continue
            mtype, ack = self._hello_reply
            if mtype == HELLO_RETRY:
                # Gated, not refused: honor the signaled backoff and
                # spend another retry.
                time.sleep(min(float(ack.get("backoff", 0.05)), timeout))
                continue
            return int(ack["sid"]), bool(ack["accepted"])
        return None, False

    def _rx(self) -> None:
        while not self._stop.is_set():
            try:
                data, _addr = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                return
            mtype, body = decode(data)
            if mtype == MALFORMED:
                continue
            if mtype in (HELLO_ACK, HELLO_RETRY):
                self._hello_reply = (mtype, body)
                self._ack_event.set()
            elif mtype in (CREDIT, REHOME) and self._source is not None:
                self.loop.post(
                    lambda data=data: self._source.control(data),
                    priority=getattr(self.loop, "PRIO_ARRIVAL", 0),
                )
