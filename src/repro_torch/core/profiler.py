"""Performance Profiler (paper §4.1): WCET lookup tables.

The paper profiles each (model, input shape, batch size) offline on the
physical GPU and stores 99th-percentile execution times. We keep that
interface but provide two backends:

- ``MeasuredProfiler``: times a callable (a jit-compiled JAX step) over
  repeated runs and stores the 99th percentile. This is the paper's method
  verbatim; on this CPU-only container it is used with reduced models, and
  the identical code path would run against a real TPU.

- ``AnalyticProfiler``: derives WCET from the roofline terms of the
  *compiled* program (``cost_analysis`` FLOPs/bytes + collective bytes
  parsed from the HLO), scaled by hardware constants and a calibration
  factor. This extends the table to meshes/shapes that were never measured,
  which the elastic-scaling path needs (a slice failure changes capacity —
  re-admission must not wait for a full re-profile).

Both produce a ``ProfileTable``. Lookups for unprofiled batch sizes are
*conservative*: the batch is first rounded up to its power-of-two bucket —
the batch the serving engine actually executes (``repro.core.bucketing``)
— then to the next profiled size (a larger batch never executes faster per
the paper's Fig 2c), falling back to linear extrapolation from the two
largest profiled points beyond the table. Because the engine, the profiler
grid, and this lookup all round through the one shared ``bucket``, the
WCET charged by admission is the WCET of the program that really runs.
"""
from __future__ import annotations

import bisect
import json
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.bucketing import bucket
from repro_torch.core.request import Category

ShapeKey = Tuple[int, ...]
TableKey = Tuple[str, ShapeKey]


def _percentile(sorted_xs: List[float], q: float) -> float:
    if not sorted_xs:
        raise ValueError("empty sample")
    idx = min(len(sorted_xs) - 1, int(math.ceil(q * len(sorted_xs))) - 1)
    return sorted_xs[max(0, idx)]


@dataclass
class ProfileTable:
    """WCET lookup: (model_id, shape_key) -> {batch_size: seconds}.

    Two entry kinds mirror the engine's two execution regimes:

    - bucketed entries (``record``): per-batch-bucket curves, used by
      prefill, whose cost grows with the padded batch;
    - flat entries (``record_flat``): ONE worst-case time per category,
      used by slot-arena decode — the engine executes the identical
      ``max_slots``-row program for every live batch, so per-step cost is
      independent of batch size and a curve would be fiction. Lookups up
      to ``max_slots`` return the flat value; beyond it they return
      ``inf`` — the engine REJECTS oversized decode dispatches (there is
      no bigger program to lazily compile), so charging infinity makes
      admission's Phase-1 filter and Phase-2 imitator reject any request
      stream that could form such a batch instead of crashing the
      serving loop at dispatch time.
    """

    entries: Dict[TableKey, Dict[int, float]] = field(default_factory=dict)
    # (model_id, shape_key) -> (max_slots, seconds): flat decode entries.
    flat_entries: Dict[TableKey, Tuple[int, float]] = field(default_factory=dict)
    # (model_id, shape_key) -> {chunk depth k: seconds}: the flat WCET
    # FAMILY of a decode category's k-step chunked programs. k=1 mirrors
    # the flat entry; deeper k amortize per-dispatch host overhead, so
    # WCET_k < k * WCET_1 on real hardware — but the family must stay
    # monotone in k (a deeper chunk never finishes before a shallower
    # one), which ``record_flat`` enforces at record time.
    chunk_entries: Dict[TableKey, Dict[int, float]] = field(default_factory=dict)
    # Multiplies every lookup; the cluster layer uses it to model degraded
    # capacity (e.g. a straggling or partially failed slice).
    capacity_scale: float = 1.0

    def record(
        self, model_id: str, shape_key: ShapeKey, batch_size: int, wcet: float
    ) -> None:
        if wcet <= 0:
            raise ValueError(f"wcet must be positive, got {wcet}")
        self.entries.setdefault((model_id, tuple(shape_key)), {})[batch_size] = wcet

    def record_flat(
        self,
        model_id: str,
        shape_key: ShapeKey,
        wcet: float,
        max_slots: int,
        k: int = 1,
    ) -> None:
        """Record a slot-arena decode category: one WCET (measured with
        every arena row active — the worst case) for any batch size.

        ``k`` records the WCET of the k-step CHUNKED program (one scanned
        dispatch executing k decode steps). k=1 is the base flat entry;
        every k also lands in the chunk family, monotone-checked: WCET
        must be non-decreasing in k, and WCET_k <= k * WCET_1 would be
        nice but is NOT required (a cold measurement may exceed it) —
        only ordering violations are rejected, because a non-monotone
        family would let the slack rule pick a deeper chunk believing it
        cheaper than a shallower one.
        """
        if wcet <= 0:
            raise ValueError(f"wcet must be positive, got {wcet}")
        if max_slots <= 0:
            raise ValueError(f"max_slots must be positive, got {max_slots}")
        if k <= 0:
            raise ValueError(f"chunk depth must be positive, got {k}")
        key = (model_id, tuple(shape_key))
        family = self.chunk_entries.setdefault(key, {})
        for k2, w2 in family.items():
            if k2 < k and w2 > wcet + 1e-12:
                raise ValueError(
                    f"non-monotone chunk family for {key}: "
                    f"WCET({k2})={w2} > WCET({k})={wcet}"
                )
            if k2 > k and w2 < wcet - 1e-12:
                raise ValueError(
                    f"non-monotone chunk family for {key}: "
                    f"WCET({k2})={w2} < WCET({k})={wcet}"
                )
        family[k] = wcet
        if k == 1:
            self.flat_entries[key] = (max_slots, wcet)
        elif key not in self.flat_entries:
            raise ValueError(
                f"chunk depth {k} recorded before the k=1 base entry for {key}"
            )

    def has(self, model_id: str, shape_key: ShapeKey) -> bool:
        key = (model_id, tuple(shape_key))
        return key in self.entries or key in self.flat_entries

    def wcet(self, model_id: str, shape_key: ShapeKey, batch_size: int) -> float:
        """Conservative WCET for a batch of ``batch_size`` frames."""
        if batch_size <= 0:
            return 0.0
        key = (model_id, tuple(shape_key))
        if key in self.flat_entries:
            slots, t = self.flat_entries[key]
            if batch_size > slots:
                return math.inf  # unservable: arena has no such program
            return t * self.capacity_scale
        try:
            table = self.entries[key]
        except KeyError:
            raise KeyError(
                f"no profile for model={model_id} shape={shape_key}; "
                f"profiled: {sorted(self.entries) + sorted(self.flat_entries)}"
            ) from None
        if batch_size in table:
            return table[batch_size] * self.capacity_scale
        # Not profiled at the true size: charge the bucket the engine will
        # actually execute (identical rounding to serving/engine.py).
        b = bucket(batch_size)
        if b in table:
            return table[b] * self.capacity_scale
        sizes = sorted(table)
        pos = bisect.bisect_left(sizes, b)
        if pos < len(sizes):
            # Round up to the next profiled batch size (conservative).
            return table[sizes[pos]] * self.capacity_scale
        # Beyond the table: linear extrapolation from the top two points
        # (batching curves are ~affine in batch size at large batch).
        if len(sizes) == 1:
            per = table[sizes[-1]] / sizes[-1]
            return per * b * self.capacity_scale
        b1, b2 = sizes[-2], sizes[-1]
        t1, t2 = table[b1], table[b2]
        slope = max((t2 - t1) / (b2 - b1), 0.0)
        return (t2 + slope * (b - b2)) * self.capacity_scale

    def wcet_for(self, category: Category, batch_size: int) -> float:
        return self.wcet(category.model_id, category.shape_key, batch_size)

    def wcet_optimistic(
        self, model_id: str, shape_key: ShapeKey, batch_size: int
    ) -> float:
        """Piecewise-linear interpolated execution time (NOT rounded up).

        Used only by the Phase-1 utilization filter, which by design must
        *underestimate* load (paper §4.2: Phase 1 may over-admit but must
        not reject feasible requests); the conservative ``wcet`` would
        inflate Ũ at unprofiled batch sizes and cause false rejects.
        Admission safety is unaffected — Phase 2 always runs ``wcet``.
        """
        if batch_size <= 0:
            return 0.0
        key = (model_id, tuple(shape_key))
        if key in self.flat_entries:
            # Flat decode cost: the optimistic estimate IS the flat time
            # (running fewer active rows is not measurably cheaper), and
            # beyond max_slots even Phase 1 must see infinity — "may
            # over-admit" never extends to batches the engine rejects.
            slots, t = self.flat_entries[key]
            if batch_size > slots:
                return math.inf
            return t * self.capacity_scale
        table = self.entries[key]
        if batch_size in table:
            return table[batch_size] * self.capacity_scale
        sizes = sorted(table)
        pos = bisect.bisect_left(sizes, batch_size)
        if pos == 0:
            per = table[sizes[0]] / sizes[0]
            return per * batch_size * self.capacity_scale
        if pos == len(sizes):
            return self.wcet(model_id, shape_key, batch_size)  # extrapolation
        b1, b2 = sizes[pos - 1], sizes[pos]
        t1, t2 = table[b1], table[b2]
        frac = (batch_size - b1) / (b2 - b1)
        return (t1 + frac * (t2 - t1)) * self.capacity_scale

    def max_profiled_batch(self, model_id: str, shape_key: ShapeKey) -> int:
        key = (model_id, tuple(shape_key))
        if key in self.flat_entries:
            return self.flat_entries[key][0]
        return max(self.entries[key])

    # -- chunk families ------------------------------------------------
    def chunk_wcet(self, model_id: str, shape_key: ShapeKey, k: int) -> float:
        """Conservative WCET for a k-step decode chunk.

        Exact hit when k was profiled; an unprofiled k rounds UP to the
        next profiled depth (running a deeper chunk's program for fewer
        steps never happens — the worker rounds depths DOWN to profiled
        members — so this path only covers direct table queries); beyond
        the family it falls back to ``k * WCET_1``, the no-amortization
        upper bound.
        """
        if k <= 0:
            return 0.0
        key = (model_id, tuple(shape_key))
        family = self.chunk_entries.get(key)
        if family:
            if k in family:
                return family[k] * self.capacity_scale
            deeper = [k2 for k2 in family if k2 > k]
            if deeper:
                return family[min(deeper)] * self.capacity_scale
        if key not in self.flat_entries:
            raise KeyError(
                f"no flat/chunk profile for model={model_id} shape={shape_key}"
            )
        return k * self.flat_entries[key][1] * self.capacity_scale

    def chunk_depths_profiled(self, model_id: str, shape_key: ShapeKey) -> List[int]:
        """Profiled chunk depths for a decode category, ascending.

        Depths the engine has a compiled-and-measured program for; the
        EDF worker's slack rule only ever picks from this list."""
        key = (model_id, tuple(shape_key))
        return sorted(self.chunk_entries.get(key, ()))

    def has_chunks(self, model_id: str, shape_key: ShapeKey) -> bool:
        """True when a depth > 1 chunk program was profiled for this key."""
        key = (model_id, tuple(shape_key))
        return any(k > 1 for k in self.chunk_entries.get(key, ()))

    def has_any_chunks(self) -> bool:
        """True when ANY category carries a depth > 1 chunk family —
        the signal DeepRT uses to auto-enable chunked dispatch."""
        return any(
            any(k > 1 for k in family) for family in self.chunk_entries.values()
        )

    def scaled(self, factor: float) -> "ProfileTable":
        """A view of this table with capacity degraded by ``factor`` >= 1."""
        return ProfileTable(
            entries=self.entries,
            flat_entries=self.flat_entries,
            chunk_entries=self.chunk_entries,
            capacity_scale=self.capacity_scale * factor,
        )

    # -- persistence ---------------------------------------------------
    def to_json(self) -> str:
        blob = {
            "capacity_scale": self.capacity_scale,
            "entries": [
                {
                    "model_id": model_id,
                    "shape_key": list(shape_key),
                    "table": {str(b): t for b, t in table.items()},
                }
                for (model_id, shape_key), table in sorted(self.entries.items())
            ],
            "flat_entries": [
                {
                    "model_id": model_id,
                    "shape_key": list(shape_key),
                    "max_slots": slots,
                    "wcet": t,
                }
                for (model_id, shape_key), (slots, t) in sorted(
                    self.flat_entries.items()
                )
            ],
            "chunk_entries": [
                {
                    "model_id": model_id,
                    "shape_key": list(shape_key),
                    "table": {str(k): t for k, t in sorted(family.items())},
                }
                for (model_id, shape_key), family in sorted(
                    self.chunk_entries.items()
                )
            ],
        }
        return json.dumps(blob, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "ProfileTable":
        blob = json.loads(text)
        table = cls(capacity_scale=blob.get("capacity_scale", 1.0))
        for e in blob["entries"]:
            for b, t in e["table"].items():
                table.record(e["model_id"], tuple(e["shape_key"]), int(b), float(t))
        for e in blob.get("flat_entries", []):
            table.record_flat(
                e["model_id"], tuple(e["shape_key"]), float(e["wcet"]),
                int(e["max_slots"]),
            )
        for e in blob.get("chunk_entries", []):
            key = (e["model_id"], tuple(e["shape_key"]))
            slots = table.flat_entries.get(key, (0,))[0]
            for k, t in sorted(e["table"].items(), key=lambda kv: int(kv[0])):
                if int(k) == 1:
                    continue  # already restored via flat_entries
                table.record_flat(
                    e["model_id"], tuple(e["shape_key"]), float(t), slots,
                    k=int(k),
                )
        return table


class MeasuredProfiler:
    """The paper's offline profiler: run each config repeatedly, take p99."""

    def __init__(self, warmup: int = 2, runs: int = 20, quantile: float = 0.99):
        self.warmup = warmup
        self.runs = runs
        self.quantile = quantile

    def profile(
        self,
        table: ProfileTable,
        model_id: str,
        shape_key: ShapeKey,
        batch_sizes: List[int],
        step_fn: Callable[[int], None],
        bucketed: bool = True,
    ) -> None:
        """``step_fn(batch_size)`` must execute one full batched step
        synchronously (for JAX: call ``.block_until_ready()`` inside).

        ``bucketed`` (default): batch sizes are rounded to their engine
        bucket first and each distinct bucket is measured ONCE — the
        engine compiles and pads identically for every true size within a
        bucket, so measuring 3 and 4 separately would time the same XLA
        program twice. The measurement is recorded under the bucket,
        which is exactly the key ``ProfileTable.wcet`` consults.
        """
        targets = sorted({bucket(b) for b in batch_sizes}) if bucketed else batch_sizes
        for b in targets:
            for _ in range(self.warmup):
                step_fn(b)
            samples = []
            for _ in range(self.runs):
                t0 = time.perf_counter()
                step_fn(b)
                samples.append(time.perf_counter() - t0)
            samples.sort()
            table.record(model_id, shape_key, b, _percentile(samples, self.quantile))


@dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants for the target accelerator (defaults: TPU v5e)."""

    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    hbm_bw: float = 819e9  # bytes/s per chip
    ici_bw: float = 50e9  # bytes/s per link
    chips: int = 1

    def step_time(
        self, flops: float, hbm_bytes: float, collective_bytes: float
    ) -> float:
        """Roofline execution-time estimate for one step: the max of the
        three terms (compute, memory, interconnect), each idealized."""
        compute = flops / (self.chips * self.peak_flops)
        memory = hbm_bytes / (self.chips * self.hbm_bw)
        collective = collective_bytes / (self.chips * self.ici_bw)
        return max(compute, memory, collective)


class AnalyticProfiler:
    """WCET from compiled-program roofline terms.

    ``cost_fn(batch_size) -> (flops, hbm_bytes, collective_bytes)`` is
    typically backed by ``repro.roofline.analysis`` over a dry-run lowering.
    ``calibration`` maps idealized roofline time to achievable WCET
    (>= 1; e.g. 1/0.6 if the program historically reaches 60% of roofline).
    """

    def __init__(self, hardware: HardwareSpec, calibration: float = 1.5):
        if calibration < 1.0:
            raise ValueError("calibration must be >= 1 (WCET cannot beat roofline)")
        self.hardware = hardware
        self.calibration = calibration

    def profile(
        self,
        table: ProfileTable,
        model_id: str,
        shape_key: ShapeKey,
        batch_sizes: List[int],
        cost_fn: Callable[[int], Tuple[float, float, float]],
    ) -> None:
        for b in batch_sizes:
            flops, hbm, coll = cost_fn(b)
            t = self.hardware.step_time(flops, hbm, coll) * self.calibration
            table.record(model_id, shape_key, b, t)
