"""Synthetic request traces (the paper's §6.2), a frozen copy of
``repro_torch/core/traces.py`` that yields plain records instead of the
program's ``Request`` objects.

Periods and relative deadlines are drawn from a Gamma distribution (shape
2, scale 5) rescaled to a target mean; request arrivals are exponential;
each request picks a model and an input shape from the pools, with the
number of distinct categories capped.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

GAMMA_K = 2.0
GAMMA_THETA = 5.0


@dataclass
class TraceSpec:
    mean_period: float
    mean_deadline: float
    n_requests: int = 25
    frames_per_request: Tuple[int, int] = (30, 120)
    models: Sequence[str] = ("resnet50",)
    shapes: Sequence[Tuple[int, ...]] = ((3, 224, 224),)
    max_categories: int = 4
    mean_interarrival: float = 1.0
    seed: int = 0


def _gamma_scaled(rng: random.Random, mean: float) -> float:
    raw = rng.gammavariate(GAMMA_K, GAMMA_THETA)
    return max(raw * mean / (GAMMA_K * GAMMA_THETA), 1e-4)


def generate_trace(spec: TraceSpec) -> List[Dict]:
    """One record per request: model, shape, period, relative_deadline,
    n_frames and start_time, drawn in the port's order."""
    rng = random.Random(spec.seed)
    pool = [(m, tuple(s)) for m in spec.models for s in spec.shapes]
    rng.shuffle(pool)
    pool = pool[: spec.max_categories]
    out: List[Dict] = []
    t = 0.0
    for _ in range(spec.n_requests):
        t += rng.expovariate(1.0 / spec.mean_interarrival)
        model, shape = rng.choice(pool)
        out.append(dict(
            model=model, shape=shape,
            period=_gamma_scaled(rng, spec.mean_period),
            relative_deadline=_gamma_scaled(rng, spec.mean_deadline),
            n_frames=rng.randint(*spec.frames_per_request),
            start_time=t,
        ))
    return out


DESKTOP_TRACES = [0.050, 0.150, 0.250]
JETSON_TRACES = [0.300, 0.450, 0.600]
