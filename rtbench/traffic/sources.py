"""Frame sources: deterministic plans of (offset, payload) per stream.

A frozen copy of ``repro_torch/ingest/sources.py`` (``FrameSource``,
``PeriodicSource``, ``CameraSource``, ``BurstSource``), kept here so that
the benchmark's traffic cannot move with the code under test. The
gateway consumes these through the same interface it consumes the
port's own sources with: ``period``, ``n_frames`` and ``plan()``, whose
items carry ``offset`` and ``payload``.

Payloads are int32 token arrays: a prompt frame carries ``(length,)``
tokens, a decode frame one token (shape ``()``).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np


@dataclass(frozen=True)
class FramePlan:
    """One planned frame: offset in seconds from the stream's start and the
    payload that arrives then."""

    offset: float
    payload: np.ndarray


class FrameSource:
    """A finite stream plan; payload ``i`` is a pure function of (seed, i)."""

    def __init__(self, period: float, n_frames: int, payload_shape: Sequence[int] = (),
                 vocab: int = 256, seed: int = 0):
        if period <= 0:
            raise ValueError(f"period must be positive, got {period}")
        if n_frames <= 0:
            raise ValueError(f"n_frames must be positive, got {n_frames}")
        if vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {vocab}")
        self.period = float(period)
        self.n_frames = int(n_frames)
        self.payload_shape = tuple(int(d) for d in payload_shape)
        self.vocab = int(vocab)
        self.seed = int(seed)

    def _offsets(self) -> List[float]:
        raise NotImplementedError

    def payload(self, index: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index))
        return rng.integers(0, self.vocab, size=self.payload_shape, dtype=np.int32)

    def plan(self) -> List[FramePlan]:
        offsets = self._offsets()
        if len(offsets) != self.n_frames:
            raise AssertionError(f"{type(self).__name__} planned {len(offsets)} offsets "
                                 f"for n_frames={self.n_frames}")
        if any(b < a for a, b in zip(offsets, offsets[1:])):
            raise AssertionError(f"{type(self).__name__} offsets not sorted")
        return [FramePlan(off, self.payload(i)) for i, off in enumerate(offsets)]

    def __iter__(self) -> Iterator[FramePlan]:
        return iter(self.plan())


class PeriodicSource(FrameSource):
    """Frame i at exactly ``i * period``."""

    def _offsets(self) -> List[float]:
        return [i * self.period for i in range(self.n_frames)]


class CameraSource(FrameSource):
    """Frame i at ``i * period + U(-j, +j)``, ``j = jitter_frac * period / 2``:
    never reordered, never before the stream's start."""

    def __init__(self, *args, jitter_frac: float = 0.2, **kwargs):
        super().__init__(*args, **kwargs)
        if not 0.0 <= jitter_frac < 1.0:
            raise ValueError(f"jitter_frac must be in [0, 1), got {jitter_frac}")
        self.jitter_frac = float(jitter_frac)

    def _offsets(self) -> List[float]:
        rng = random.Random(f"camera-{self.seed}")
        half = self.jitter_frac * self.period / 2.0
        return [max(0.0, i * self.period + rng.uniform(-half, half))
                for i in range(self.n_frames)]


class BurstSource(FrameSource):
    """On/off stream: groups of ``burst`` frames; ``duty < 1`` packs the
    same frames into a ``duty`` share of the declared time."""

    def __init__(self, *args, burst: int = 4, duty: float = 1.0, intra_frac: float = 0.25,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {duty}")
        if not 0.0 < intra_frac <= 1.0:
            raise ValueError(f"intra_frac must be in (0, 1], got {intra_frac}")
        self.burst = int(burst)
        self.duty = float(duty)
        self.intra_frac = float(min(intra_frac, duty))

    def _offsets(self) -> List[float]:
        eff = self.period * self.duty
        intra = eff * self.intra_frac
        out: List[float] = []
        for i in range(self.n_frames):
            k, j = divmod(i, self.burst)
            out.append(k * self.burst * self.period * self.duty + j * intra)
        return out


SOURCES = {"periodic": PeriodicSource, "camera": CameraSource, "burst": BurstSource}
