"""The one traffic generator: a mix file and a seed -> the cell's streams.

A mix (``traffic/mixes/<name>.json``) lists stream classes. Each class
fixes its kind (``decode``: one token a frame through an arena row;
``prefill``: a prompt of ``length`` tokens a frame), its number of
streams, period, relative deadline, source and the source's jitter.
These never depend on the seed, so every seed offers the same load.
The seed draws only the payload tokens and the jitter.

Streams of a class start at evenly spread phases over one period. Every
planned frame is due inside the window ``[0, seconds)``: a stream plans
as many frames as fit with their jitter. ``order`` says how streams are
registered: ``"classes"`` class by class as listed, ``"interleave"`` in
proportion, so that a refusal falls on every class alike.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List

from rtbench.traffic.sources import SOURCES, FrameSource

KINDS = ("decode", "prefill")


@dataclass
class Stream:
    cls: str
    index: int  # within its class
    kind: str
    length: int  # tokens a frame (1 for decode)
    period: float
    deadline: float
    phase: float  # seconds after the window opens that the stream starts
    source: FrameSource


def stream_seed(seed: int, cls: str, index: int) -> int:
    """A stream's payload and jitter seed: a pure function of the run's
    seed, the class and the stream's index (63 bits)."""
    digest = hashlib.sha256(f"{int(seed)}/{cls}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def check_mix(mix: Dict) -> None:
    classes = mix.get("classes")
    if not classes:
        raise ValueError("a traffic mix needs at least one class")
    names = set()
    for c in classes:
        for key in ("name", "kind", "count", "period_s", "deadline_s", "source"):
            if key not in c:
                raise ValueError(f"traffic class {c.get('name')!r} lacks {key!r}")
        if c["kind"] not in KINDS:
            raise ValueError(f"traffic class {c['name']!r}: kind {c['kind']!r} not in {KINDS}")
        if c["kind"] == "prefill" and int(c.get("length", 0)) < 1:
            raise ValueError(f"traffic class {c['name']!r}: a prefill class needs a length")
        if c["source"] not in SOURCES:
            raise ValueError(f"traffic class {c['name']!r}: unknown source {c['source']!r}")
        if c["name"] in names:
            raise ValueError(f"traffic class {c['name']!r} listed twice")
        names.add(c["name"])
    if mix.get("order", "classes") not in ("classes", "interleave"):
        raise ValueError(f"unknown order {mix.get('order')!r}")


def _frames_in_window(phase: float, period: float, slack: float, seconds: float) -> int:
    n = 0
    while phase + n * period + slack < seconds:
        n += 1
    return n


def streams(mix: Dict, seed: int, seconds: float, vocab: int) -> List[Stream]:
    """The cell's streams in registration order."""
    check_mix(mix)
    out: List[Stream] = []
    for c in mix["classes"]:
        count = int(c["count"])
        period = float(c["period_s"])
        jitter = float(c.get("jitter", 0.0))
        kind = c["kind"]
        length = 1 if kind == "decode" else int(c["length"])
        for j in range(count):
            phase = float(c.get("phase_s", 0.0)) + j * period / count
            n = _frames_in_window(phase, period, jitter * period / 2.0, seconds)
            if n < 1:
                continue
            kw = dict(payload_shape=() if kind == "decode" else (length,), vocab=vocab,
                      seed=stream_seed(seed, c["name"], j))
            if c["source"] == "camera":
                kw["jitter_frac"] = jitter
            elif c["source"] == "burst":
                kw.update({k: c[k] for k in ("burst", "duty", "intra_frac") if k in c})
            src = SOURCES[c["source"]](period, n, **kw)
            out.append(Stream(c["name"], j, kind, length, period, float(c["deadline_s"]),
                              phase, src))
    if mix.get("order", "classes") == "interleave":
        counts = {c["name"]: int(c["count"]) for c in mix["classes"]}
        rank = {c["name"]: i for i, c in enumerate(mix["classes"])}
        out.sort(key=lambda s: ((s.index + 0.5) / counts[s.cls], rank[s.cls]))
    return out
