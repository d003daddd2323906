"""Shared batch rounding for the live engine and the admission imitator.

Two regimes, one module, so the engine, the profiler grid, and the WCET
lookup can never drift apart (drift silently breaks the Phase-2
guarantee: the imitator's timeline would be faster than reality):

- PREFILL stays power-of-two bucketed: the engine compiles one XLA
  program per (model, seq bucket, batch bucket) via ``bucket``, so the
  compile count is logarithmic and admission charges the batch the
  engine actually pads to.
- DECODE is served from a resident slot arena (``serving/engine.py``):
  ONE compiled program per (model, seq) always executes ``max_slots``
  rows, and the live batch size is data (an active-slot bitmap), not a
  shape. Per-step decode cost is therefore FLAT in batch size, and the
  WCET table stores a single flat entry per decode category
  (``ProfileTable.record_flat``) instead of a per-bucket curve.
  ``arena_slots`` is the one place the arena's row count is derived.

Keep this module dependency-free (stdlib only); it is imported by the
engine, the profiler, and the admission path.
"""
from __future__ import annotations

import math
from typing import List


def bucket(n: int) -> int:
    """Next power of two >= n (the batch bucket the engine executes).

    ``bucket(0) == 0`` so zero-frame lookups stay free; negative sizes are
    a caller bug and raise.
    """
    if n < 0:
        raise ValueError(f"batch size must be >= 0, got {n}")
    if n <= 1:
        return n
    return 1 << (n - 1).bit_length()


def bucket_sizes(max_batch: int) -> List[int]:
    """All buckets up to and including ``bucket(max_batch)``: 1, 2, 4, ...

    The canonical profiling grid — profiling exactly the buckets makes
    every conservative table lookup an exact hit.
    """
    if max_batch <= 0:
        return []
    out = [1]
    while out[-1] < bucket(max_batch):
        out.append(out[-1] * 2)
    return out


def arena_slots(max_batch: int) -> int:
    """Row count of a model's resident decode arena.

    The arena is sized to the power-of-two bucket of the largest batch
    admission can produce, so any admitted decode job fits without a
    reshape or recompile. Sizing rule (documented in ROADMAP.md): the
    Phase-1 utilization filter bounds the mean frames per DisBatcher
    window at ``n_g = floor(sum_m W_g / p_m)``; size the arena to
    ``arena_slots(n_g_max + 1)`` over the categories the engine serves
    (the +1 absorbs the ceil of an in-flight partial period).
    """
    if max_batch <= 0:
        raise ValueError(f"arena needs >= 1 slot, got max_batch={max_batch}")
    return bucket(max_batch)


def slice_arena_slots(
    max_batch: int, utilization_bound: float = 1.0, min_slots: int = 1
) -> int:
    """Row count of ONE device slice's resident decode arena.

    A cluster partitions admissible load across slices by giving each a
    Phase-1 utilization bound β <= 1 (admission on that slice rejects
    anything pushing its Ũ past β). The frames-per-window bound scales
    the same way — ``n_g = floor(sum_m W_g / p_m)`` is what the
    utilization formula multiplies by E/W — so a slice carrying a β
    share of the load needs only ``ceil(β * max_batch)`` rows before
    rounding to the arena bucket. β = 1 degenerates to ``arena_slots``
    (the single-device rule). ``min_slots`` floors the result so a
    thin slice can still host at least one decode stream.
    """
    if not 0.0 < utilization_bound <= 1.0:
        raise ValueError(
            f"utilization_bound must be in (0, 1], got {utilization_bound}"
        )
    if min_slots < 1:
        raise ValueError(f"min_slots must be >= 1, got {min_slots}")
    return arena_slots(max(min_slots, math.ceil(utilization_bound * max_batch)))


def chunk_depths(max_depth: int) -> List[int]:
    """Power-of-two decode chunk depths up to ``bucket(max_depth)``: 1, 2, 4...

    The canonical profiling grid for multi-step decode chunks. The engine
    compiles ONE scanned program per (model, seq, k) for each k in this
    ladder, the profiler measures exactly those k, and the EDF worker's
    slack-chosen depth rounds DOWN to a member — so, like batch buckets,
    the chunk the worker charges is the chunk the engine actually runs.
    """
    if max_depth <= 0:
        return []
    out = [1]
    while out[-1] < bucket(max_depth):
        out.append(out[-1] * 2)
    return out


def padding_fraction(true_batch: int, bucket_batch: int = 0) -> float:
    """Fraction of executed batch slots that carry no real frame."""
    bb = bucket_batch or bucket(true_batch)
    if bb <= 0:
        return 0.0
    return (bb - true_batch) / bb
