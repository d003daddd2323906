"""Synthetic request traces (paper §6.2).

Periods and relative deadlines are sampled independently from a Gamma
distribution (shape k=2, scale θ=5 — the paper's queueing-theory choice)
and rescaled so the trace mean matches a target (paper Table 2: 50/150/250
ms on the desktop, 300/450/600 ms on the Jetson). Request inter-arrival
times follow a bursty exponential process standing in for the Twitter
trace the paper uses as an arrival-pattern reference. Each request picks a
model and an input shape uniformly from the configured pools, with the
number of distinct categories capped (paper: "we limit the number of
categories of requests").
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.request import Category, Request

GAMMA_K = 2.0
GAMMA_THETA = 5.0


@dataclass
class TraceSpec:
    mean_period: float  # seconds
    mean_deadline: float  # seconds
    n_requests: int = 25  # paper: 20-30 per trace
    frames_per_request: Tuple[int, int] = (30, 120)
    models: Sequence[str] = ("resnet50",)
    shapes: Sequence[Tuple[int, ...]] = ((3, 224, 224),)
    max_categories: int = 4
    mean_interarrival: float = 1.0  # request arrivals (Twitter-like)
    seed: int = 0


def _gamma_scaled(rng: random.Random, mean: float) -> float:
    raw = rng.gammavariate(GAMMA_K, GAMMA_THETA)
    return max(raw * mean / (GAMMA_K * GAMMA_THETA), 1e-4)


def generate_trace(spec: TraceSpec) -> List[Request]:
    rng = random.Random(spec.seed)
    pool = [
        Category(model_id=m, shape_key=s)
        for m in spec.models
        for s in spec.shapes
    ]
    rng.shuffle(pool)
    pool = pool[: spec.max_categories]
    out: List[Request] = []
    t = 0.0
    for _ in range(spec.n_requests):
        t += rng.expovariate(1.0 / spec.mean_interarrival)
        cat = rng.choice(pool)
        out.append(
            Request(
                category=cat,
                period=_gamma_scaled(rng, spec.mean_period),
                relative_deadline=_gamma_scaled(rng, spec.mean_deadline),
                n_frames=rng.randint(*spec.frames_per_request),
                start_time=t,
            )
        )
    return out


# The paper's two hardware settings (Table 2), in seconds.
DESKTOP_TRACES = [0.050, 0.150, 0.250]
JETSON_TRACES = [0.300, 0.450, 0.600]
