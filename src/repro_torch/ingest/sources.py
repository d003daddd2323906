"""Frame sources: where real payload bytes come from (paper §3.1).

DeepRT's clients are periodic soft-real-time streams — smartphone and
IoT cameras pushing frames at a nominal rate that reality never quite
honors. A ``FrameSource`` models one client stream as a DETERMINISTIC
plan: a finite sequence of ``(offset_seconds, payload)`` pairs, fully
determined by the source's seed. Determinism is the load-bearing
property — the gateway schedules the same plan onto a virtual
``EventLoop`` (simulation over ``SequentialDevice``) or a ``WallClock``
(live serving), and the two runs ingest bit-identical bytes at
bit-identical stream offsets. Sources hold no clock and no mutable
iteration state; ``plan()`` can be re-materialized any number of times.

Three shapes, matching the arrival patterns the paper's edge setting
actually sees:

- ``CameraSource``  — jittery periodic: frame i at ``i*period`` plus
  bounded uniform jitter (|jitter| <= jitter_frac * period / 2, so
  arrival order is preserved). The surveillance-camera workload.
- ``BurstSource``   — WebRTC-like on/off process: frames arrive in
  back-to-back bursts separated by silence. The DECLARED period (what
  admission is told, ``period``) still averages out over the whole
  stream when ``duty=1.0``; ``duty < 1`` compresses the same frame
  count into a fraction of the time — a stream whose instantaneous
  rate exceeds its admitted rate by 1/duty, which is exactly the
  overload the gateway's load shedding exists for.
- ``TraceSource``   — replay of a ``core.traces`` request: offsets at
  the trace's Gamma-sampled period, payloads from the trace seed. The
  bridge from the paper's synthetic trace experiments to real bytes.

Payloads are int32 token arrays for the LM categories this repo serves:
prefill frames carry ``(seq,)`` tokens, decode frames carry one token
(shape ``()``). ``payload_shape`` picks which.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import Request
from repro_torch.core.traces import TraceSpec, generate_trace

DEFAULT_VOCAB = 256  # payload token range; tiny() configs all exceed it


@dataclass(frozen=True)
class FramePlan:
    """One planned frame: stream offset (seconds from session start) and
    the payload bytes that 'arrive' at that instant."""

    offset: float
    payload: np.ndarray


class FrameSource:
    """Deterministic finite stream plan. Subclasses implement
    ``_offsets``; payload generation is shared (seeded per frame index,
    so payload i is independent of how offsets were produced)."""

    def __init__(
        self,
        period: float,
        n_frames: int,
        payload_shape: Sequence[int] = (),
        vocab: int = DEFAULT_VOCAB,
        seed: int = 0,
    ):
        if period <= 0:
            raise ValueError(f"period must be positive, got {period}")
        if n_frames <= 0:
            raise ValueError(f"n_frames must be positive, got {n_frames}")
        if vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {vocab}")
        self.period = float(period)  # the DECLARED (admission-visible) rate
        self.n_frames = int(n_frames)
        self.payload_shape = tuple(int(d) for d in payload_shape)
        self.vocab = int(vocab)
        self.seed = int(seed)

    # -- plan -----------------------------------------------------------
    def _offsets(self) -> List[float]:
        raise NotImplementedError

    def payload(self, index: int) -> np.ndarray:
        """Frame ``index``'s payload bytes — pure function of (seed, index)."""
        rng = np.random.default_rng((self.seed, index))
        return rng.integers(
            0, self.vocab, size=self.payload_shape, dtype=np.int32
        )

    def plan(self) -> List[FramePlan]:
        """The full arrival plan, re-materializable and deterministic."""
        offsets = self._offsets()
        if len(offsets) != self.n_frames:
            raise AssertionError(
                f"{type(self).__name__} planned {len(offsets)} offsets "
                f"for n_frames={self.n_frames}"
            )
        if any(b < a for a, b in zip(offsets, offsets[1:])):
            raise AssertionError(f"{type(self).__name__} offsets not sorted")
        return [FramePlan(off, self.payload(i)) for i, off in enumerate(offsets)]

    def __iter__(self) -> Iterator[FramePlan]:
        return iter(self.plan())


class PeriodicSource(FrameSource):
    """Strict-periodic stream: frame i at exactly ``i * period``. The
    declared contract with zero jitter — the transport layer's baseline
    client and the stand-in the server builds from a HELLO's declared
    (period, n_frames) when admission-testing a remote stream."""

    def _offsets(self) -> List[float]:
        return [i * self.period for i in range(self.n_frames)]


class CameraSource(FrameSource):
    """Jittery periodic camera: frame i at ``i*period + U(-j, +j)`` with
    ``j = jitter_frac * period / 2`` — jitter never reorders frames and
    never moves frame 0 before the session start."""

    def __init__(self, *args, jitter_frac: float = 0.2, **kwargs):
        super().__init__(*args, **kwargs)
        if not 0.0 <= jitter_frac < 1.0:
            raise ValueError(
                f"jitter_frac must be in [0, 1), got {jitter_frac}"
            )
        self.jitter_frac = float(jitter_frac)

    def _offsets(self) -> List[float]:
        # str seeding is deterministic across processes (tuple seeding
        # would fall back to hash(), which PYTHONHASHSEED randomizes).
        rng = random.Random(f"camera-{self.seed}")
        half = self.jitter_frac * self.period / 2.0
        return [
            max(0.0, i * self.period + rng.uniform(-half, half))
            for i in range(self.n_frames)
        ]


class BurstSource(FrameSource):
    """On/off bursty stream (WebRTC-like network source).

    Frames come in groups of ``burst``; burst k starts at
    ``k * burst * period * duty``, so the stream delivers its declared
    mean rate 1/period when ``duty=1.0`` and compresses the SAME frame
    budget into a ``duty`` fraction of the time otherwise (mean rate
    ``1/(period*duty)``). ``duty=0.5`` is the benchmark's 2x overload
    replay: the whole admitted frame budget arrives in half the
    admitted time.
    """

    def __init__(
        self,
        *args,
        burst: int = 4,
        duty: float = 1.0,
        intra_frac: float = 0.25,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {duty}")
        if not 0.0 < intra_frac <= 1.0:
            raise ValueError(f"intra_frac must be in (0, 1], got {intra_frac}")
        self.burst = int(burst)
        self.duty = float(duty)
        # Intra-burst spacing as a fraction of the EFFECTIVE period; must
        # stay below duty so a burst finishes before the next one starts.
        self.intra_frac = float(min(intra_frac, duty))

    def _offsets(self) -> List[float]:
        eff = self.period * self.duty  # mean spacing the stream really has
        burst_stride = self.burst * self.period  # declared-rate spacing of bursts
        intra = eff * self.intra_frac
        out: List[float] = []
        for i in range(self.n_frames):
            k, j = divmod(i, self.burst)
            out.append(k * burst_stride * self.duty + j * intra)
        return out


class TraceSource(FrameSource):
    """Replay one ``core.traces`` request as a payload-carrying stream:
    strict-periodic offsets at the trace's sampled period."""

    def __init__(
        self,
        request: Request,
        payload_shape: Sequence[int] = (),
        vocab: int = DEFAULT_VOCAB,
        seed: Optional[int] = None,
    ):
        super().__init__(
            period=request.period,
            n_frames=request.n_frames,
            payload_shape=payload_shape,
            vocab=vocab,
            seed=request.request_id if seed is None else seed,
        )
        self.request = request

    def _offsets(self) -> List[float]:
        return [i * self.period for i in range(self.n_frames)]

    @classmethod
    def from_trace(
        cls,
        spec: TraceSpec,
        payload_shape: Sequence[int] = (),
        vocab: int = DEFAULT_VOCAB,
    ) -> List[Tuple[Request, "TraceSource"]]:
        """One (request, source) pair per trace entry; the request keeps
        its trace start_time, the source's offsets are relative to it."""
        return [
            (req, cls(req, payload_shape=payload_shape, vocab=vocab, seed=i))
            for i, req in enumerate(generate_trace(spec))
        ]
