"""Inference engine: batched steps for DeepRT categories, in PyTorch.

Two execution regimes, as in ``repro.serving.engine``:

- PREFILL (full forward over (b, seq) tokens -> last-token argmax) is
  bucketed: batch sizes pad up to the next power of two via the shared
  ``repro_torch.core.bucketing.bucket`` (the same rounding the profiler
  grid and the admission WCET lookup use).

- DECODE (one token against a KV cache) runs on a SLOT ARENA: each
  (model, seq) owns ONE resident KV arena of ``max_slots`` rows that
  lives across steps and is updated IN PLACE, and ONE step that always
  executes all ``max_slots`` rows. The live batch size is DATA (a
  per-row active bitmap + per-row cursors on the device), not a shape:
  any batch 1..max_slots runs the same step, rows are assigned/freed by
  the slot allocator and recycled with an in-place row reset, and dead
  rows carry ``active=0`` so the decode attention kernel skips all their
  KV tiles.

Where the reference relies on XLA, this engine does the same job by
hand:

- ``dispatch`` enqueues a step on the current CUDA stream WITHOUT
  blocking and records a CUDA event after it; ``StepHandle.wait``
  synchronizes on that event (the ``AsyncDevice`` waiter thread calls
  it). ``execute`` (= dispatch + wait) is the synchronous path for the
  offline profiler.
- There is no KV donation to ask for: the arena is one resident buffer
  written in place by every step. ``donate_cache`` is accepted for
  interface parity and has no effect.
- There are no jit program caches: each (kind, mid, seq[, batch]) gets a
  plain step closure on first use. ``stats["decode_compiles"]`` counts
  the first build of a (mid, seq) decode step and stays 0 after warm-up.
- Parameters are made ON THE DEVICE, in each config's ``param_dtype``,
  from a ``torch.Generator`` on that device seeded from ``seed``;
  callers may pass ready parameters instead (``params=``).
- Inputs are staged through ``StagingRing``s (pinned host buffers,
  non-blocking copies) guarded by the step that consumes them.

Multi-step decode chunks (``decode_chunk``) and CUDA graphs are not
ported yet (ROADMAP.md): ``chunk_depth > 1`` raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bucketing import bucket
from repro_torch.ingest.staging import StagingRing, check_payload_dtype
from repro_torch.models import model_for
from repro_torch.models.kvcache import (
    cache_nbytes,
    cache_reset_rows,
    ring_cache_present_window,
)


def resolve_device(device) -> torch.device:
    """The engine's device; CUDA must really be there (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclass
class StepHandle:
    """One in-flight dispatched step (outputs may still be computing)."""

    outputs: Any  # prefill -> next tokens (b,); decode -> logits (m, V)
    mid: str
    kind: str
    true_batch: int
    bucket_batch: int  # prefill: the pow2 bucket; decode: max_slots
    event: Optional[Any] = None  # torch.cuda.Event recorded after the step

    def wait(self) -> Any:
        """Block until the device finishes; returns the ready outputs."""
        if self.event is not None:
            self.event.synchronize()
        return self.outputs


@dataclass
class SlotArena:
    """One model's resident decode state for one seq length.

    ``cache`` is the single KV buffer (batch axis = max_slots) that lives
    across steps and is written in place. ``presented``: its ring caches
    hold a full window of positions for prefix-mode decode. ``cur``/``active`` are
    DEVICE-resident per-row cursors and the live-slot bitmap, updated in
    place: steady-state slot-mode decode does no host->device transfer
    besides the staged tokens. ``free`` are the unassigned row ids;
    ``allocs``/``resets`` count allocator traffic.
    """

    cache: Any
    max_slots: int
    cur: torch.Tensor = None
    active: torch.Tensor = None
    free: List[int] = field(default_factory=list)
    allocs: int = 0
    resets: int = 0
    # Ring positions presented for prefix-mode decode (cleared when the
    # allocator wipes rows).
    presented: bool = False

    @property
    def live(self) -> Tuple[int, ...]:
        free = set(self.free)
        return tuple(i for i in range(self.max_slots) if i not in free)


class InferenceEngine:
    def __init__(
        self,
        configs: Dict[str, ModelConfig],
        seed: int = 0,
        donate_cache: Optional[bool] = None,
        masked_decode: bool = True,
        max_slots: int = 8,
        chunk_depth: int = 1,
        device="cuda",
        params: Optional[Dict[str, Any]] = None,
    ):
        """``donate_cache``: accepted, no effect (the arena is always
        updated in place). ``masked_decode=False`` recreates blind padding
        (every arena row does full attention work). ``max_slots``: decode
        arena rows per (model, seq). ``chunk_depth`` must be 1 until
        multi-step decode chunks are ported. ``device``: ``"cuda"`` (the
        default) or ``"cpu"``. ``params``: ready parameter trees by model
        id (e.g. from ``repro_torch.interop``); other models are drawn
        from the seeded generator.
        """
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if chunk_depth < 1:
            raise ValueError(f"chunk_depth must be >= 1, got {chunk_depth}")
        if chunk_depth > 1:
            raise NotImplementedError(
                "multi-step decode chunks are not ported yet "
                "(ROADMAP.md: decode_chunk and CUDA graphs)"
            )
        self.device = resolve_device(device)
        self.configs = dict(configs)
        self.models = {mid: model_for(cfg) for mid, cfg in configs.items()}
        self.donate_cache = donate_cache
        self.masked_decode = masked_decode
        self.max_slots = max_slots
        given = dict(params or {})
        self.params = {}
        for i, (mid, model) in enumerate(self.models.items()):
            if mid in given:
                self.params[mid] = given[mid]
                continue
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed * 1_000_003 + i)
            with torch.no_grad():
                self.params[mid] = model.init(gen, device=self.device)
        self._steps: Dict[Tuple, Any] = {}
        self._arenas: Dict[Tuple[str, int], SlotArena] = {}
        self._rings: Dict[Tuple, StagingRing] = {}
        # Prefix-mode decode inputs per (mid, seq, live-count): tiny
        # (max_slots,) device tensors, cached so the hot loop re-sends
        # resident tensors.
        self._decode_inputs: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.frozen = False
        self.stats: Dict[str, int] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero the padding/dispatch/compile counters. build_live_scheduler
        calls this after the offline profiling pass so ``stats`` reflects
        only served traffic — ``decode_compiles`` then counts step builds
        AFTER warm-up, which the slot arena holds at 0."""
        self.stats.update(
            real_rows=0, bucket_rows=0, real_slots=0, total_slots=0,
            dispatches=0, decode_compiles=0, prefill_compiles=0,
        )

    def freeze(self) -> None:
        """Permanently disable dispatch and slot traffic (idempotent)."""
        self.frozen = True

    def _check_not_frozen(self, op: str) -> None:
        if self.frozen:
            raise RuntimeError(
                f"engine is frozen (its slice failed); {op} must target a "
                f"surviving slice's engine"
            )

    def _record(self) -> Optional[Any]:
        """A CUDA event recorded on the current stream after the step just
        enqueued, or None on the CPU (where the step already ran)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # ----- step factories --------------------------------------------------
    def _prefill_fn(self, mid: str, seq: int, batch: int):
        key = ("prefill", mid, seq, batch)
        if key not in self._steps:
            self.stats["prefill_compiles"] += 1
            model = self.models[mid]

            def run(params, tokens):
                with torch.no_grad():
                    logits, _ = model.forward(params, tokens)
                    return logits[:, -1].argmax(-1)

            self._steps[key] = run
        return self._steps[key]

    def _decode_fn(self, mid: str, seq: int):
        """THE decode step for (mid, seq): every live batch <= max_slots
        runs it. It also advances the live rows' cursors on the device
        (clamped at the cache edge; a real system would evict)."""
        key = ("decode", mid, seq)
        if key not in self._steps:
            self.stats["decode_compiles"] += 1
            model = self.models[mid]

            def run(params, cache, tok, cur, active):
                with torch.no_grad():
                    logits, cache = model.decode_step(
                        params, cache, tok, cur, active=active
                    )
                    new_cur = torch.where(active, (cur + 1).clamp_(max=seq - 1), cur)
                return logits, cache, new_cur

            self._steps[key] = run
        return self._steps[key]

    # ----- slot arena ------------------------------------------------------
    def arena(self, mid: str, seq: int) -> SlotArena:
        """The resident decode arena for (mid, seq), created on first use."""
        key = (mid, seq)
        if key not in self._arenas:
            m = self.max_slots
            self._arenas[key] = SlotArena(
                cache=self.models[mid].init_cache(m, seq, device=self.device),
                max_slots=m,
                cur=torch.zeros((m,), dtype=torch.int32, device=self.device),
                active=torch.zeros((m,), dtype=torch.bool, device=self.device),
                free=list(range(m)),
            )
        return self._arenas[key]

    def _row_mask(self, ids: Sequence[int]) -> torch.Tensor:
        rows = torch.zeros((self.max_slots,), dtype=torch.bool)
        if ids:
            rows[list(ids)] = True
        return rows.to(self.device)

    def alloc_slots(
        self, mid: str, seq: int, n: int, start_pos: int = 0
    ) -> Tuple[int, ...]:
        """Assign ``n`` arena rows to an admitted request. Recycled rows
        are wiped in place (``cache_reset_rows``); the arena is never
        reallocated. Raises when the arena is full."""
        self._check_not_frozen("alloc_slots")
        arena = self.arena(mid, seq)
        if n < 1:
            raise ValueError(f"need >= 1 slot, got {n}")
        if n > len(arena.free):
            raise RuntimeError(
                f"arena {mid}/seq={seq} exhausted: want {n}, "
                f"free {len(arena.free)}/{arena.max_slots} — admission "
                f"must bound live batches by max_slots"
            )
        slots = tuple(sorted(arena.free)[:n])
        arena.free = [s for s in arena.free if s not in slots]
        rows = self._row_mask(slots)
        cache_reset_rows(arena.cache, rows)
        arena.presented = False
        arena.cur.masked_fill_(rows, start_pos)
        arena.active.logical_or_(rows)
        arena.allocs += n
        arena.resets += n
        return slots

    def free_slots(self, mid: str, seq: int, slots: Sequence[int]) -> None:
        """Return rows to the allocator (wiped lazily on next alloc)."""
        self._check_not_frozen("free_slots")
        arena = self.arena(mid, seq)
        ids = [int(s) for s in slots]
        if not ids:
            return
        bad = [s for s in ids if not 0 <= s < arena.max_slots]
        if bad:
            raise ValueError(f"slot ids out of range: {bad}")
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate slot ids in free: {sorted(ids)}")
        not_live = sorted(set(ids) - set(arena.live))
        if not_live:
            raise ValueError(f"double free / never-allocated slots {not_live}")
        arena.free.extend(ids)
        arena.active.logical_and_(~self._row_mask(ids))

    def arena_nbytes(self, mid: str, seq: int) -> int:
        """Resident bytes of the (mid, seq) decode arena."""
        return cache_nbytes(self.arena(mid, seq).cache)

    # ----- double-buffered input staging ----------------------------------
    def staging_ring(self, kind: str, mid: str, seq: int, batch: int) -> StagingRing:
        """The host->device staging ring for one step input (prefill:
        (bucket, seq) token rows; decode: (max_slots,) tokens)."""
        key = (kind, mid, seq, batch)
        ring = self._rings.get(key)
        if ring is None:
            shape = (batch, seq) if kind == "prefill" else (batch,)
            # Two buffers: the EDF worker keeps one job in flight, so one
            # scratch is read by the device while the other is filled.
            ring = StagingRing(shape, np.int32, depth=2, device=self.device)
            self._rings[key] = ring
        return ring

    def _stage_prefill_tokens(
        self, ring: StagingRing, payload, n_rows: int
    ) -> torch.Tensor:
        """Stage one prefill's token rows. ``payload``: None (zero frame),
        a dense (n_rows, seq) array, or a per-frame list of Optional row
        arrays. Rows longer than the running seq are CROPPED, shorter
        rows zero-pad."""
        if payload is None or isinstance(payload, np.ndarray):
            return ring.stage_rows(payload, n_rows)
        rows = list(payload)
        if len(rows) != n_rows:
            raise ValueError(
                f"prefill payload carries {len(rows)} rows for batch {n_rows}"
            )
        seq_run = ring.shape[1]

        arrs = []
        for r in rows:
            if r is None:
                arrs.append(None)
                continue
            arr = np.asarray(r).ravel()
            check_payload_dtype(arr, ring.dtype)
            arrs.append(arr)

        def fill(buf: np.ndarray) -> None:
            for i, arr in enumerate(arrs):
                if arr is None:
                    buf[i] = 0
                    continue
                n = min(arr.size, seq_run)
                buf[i, :n] = arr[:n]
                buf[i, n:] = 0
            buf[n_rows:] = 0

        return ring.stage(fill)

    def _stage_decode_tokens(
        self, ring: StagingRing, payload, prefix_rows: Optional[int]
    ) -> torch.Tensor:
        """Stage one decode step's token vector (all ``max_slots`` rows).

        ``prefix_rows`` set (prefix-mode dispatch): ``payload`` is None, a
        (prefix_rows,) token array, or a per-frame list of Optional
        scalars for the leading rows. Otherwise (slot mode): ``payload``
        is None, a full (max_slots,) slot-aligned array, or a
        {slot_id: token} dict.
        """
        if payload is None:
            return ring.stage_rows(None, 0)
        if prefix_rows is not None:
            if isinstance(payload, np.ndarray):
                return ring.stage_rows(payload, prefix_rows)
            toks = list(payload)
            if len(toks) != prefix_rows:
                raise ValueError(
                    f"decode payload carries {len(toks)} tokens for "
                    f"batch {prefix_rows}"
                )

            def fill_prefix(buf: np.ndarray) -> None:
                buf[:] = 0
                for i, t in enumerate(toks):
                    if t is not None:
                        buf[i] = int(np.asarray(t))

            return ring.stage(fill_prefix)
        if isinstance(payload, dict):
            m = ring.shape[0]
            bad = [s for s in payload if not 0 <= int(s) < m]
            if bad:
                raise ValueError(f"decode payload slot ids out of range: {bad}")

            def fill(buf: np.ndarray) -> None:
                buf[:] = 0
                for s, tok in payload.items():
                    buf[int(s)] = tok

            return ring.stage(fill)
        return ring.stage_rows(payload, ring.shape[0])

    def _prefix_inputs(
        self, mid: str, seq: int, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cursors, active) for a job occupying the first ``k`` arena
        rows: every row sits at position seq-1 (so a dead row's cache
        write keeps a presented ring full), dead rows carry active=0.
        Cached per (mid, seq, k) as device tensors."""
        if not self.masked_decode:
            k = self.max_slots  # blind padding: every row does full work
        key = (mid, seq, k)
        if key not in self._decode_inputs:
            m = self.max_slots
            cur = torch.full((m,), seq - 1, dtype=torch.int32)
            active = torch.arange(m) < k
            self._decode_inputs[key] = (cur.to(self.device), active.to(self.device))
        return self._decode_inputs[key]

    # ----- execution ---------------------------------------------------------
    def warmup(self, mid: str, shape_key: Tuple[int, ...], batch_sizes,
               kind: str = "prefill") -> None:
        for b in batch_sizes:
            self.execute(mid, shape_key, b, kind)

    def dispatch(
        self, mid: str, shape_key: Tuple[int, ...], batch_size: int,
        kind: str = "prefill", slots: Optional[Sequence[int]] = None,
        payload=None, step_rows: Optional[Sequence[int]] = None,
    ) -> StepHandle:
        """Enqueue one batched job WITHOUT waiting for the device.

        shape_key = (seq_len,). Decode jobs run on the slot arena:
        ``slots`` steps the allocator-assigned rows (the set must be ALL
        currently live rows); ``slots=None`` uses the first ``batch_size``
        rows (the profiler/benchmark workload). ``payload`` carries the
        job's tokens through the staging ring (None = a zero frame).
        ``step_rows`` (slot mode only): the live rows that carry a REAL
        token this step; the others run with ``active=0`` and keep their
        cursor.
        """
        self._check_not_frozen("dispatch")
        seq = shape_key[0]
        self.stats["dispatches"] += 1
        if kind == "prefill":
            b = bucket(batch_size)
            self.stats["real_rows"] += batch_size
            self.stats["bucket_rows"] += b
            fn = self._prefill_fn(mid, seq, b)
            ring = self.staging_ring("prefill", mid, seq, b)
            tokens = self._stage_prefill_tokens(ring, payload, batch_size)
            out = fn(self.params[mid], tokens)
            handle = StepHandle(out, mid, kind, batch_size, b, event=self._record())
            # The handle's wait guards this scratch buffer's reuse: the
            # ring refills it only after the copy and the step are done.
            ring.attach_consumer(handle.wait)
            return handle
        if batch_size > self.max_slots:
            raise ValueError(
                f"decode batch {batch_size} > max_slots {self.max_slots}: "
                f"size the arena via bucketing.arena_slots at engine build"
            )
        m = self.max_slots
        arena = self.arena(mid, seq)
        fn = self._decode_fn(mid, seq)
        ring = self.staging_ring("decode", mid, seq, m)
        tok = self._stage_decode_tokens(
            ring, payload, prefix_rows=batch_size if slots is None else None
        )
        if slots is None:
            if len(arena.free) != arena.max_slots:
                raise ValueError(
                    f"arena {mid}/seq={seq} has allocator-live rows "
                    f"{sorted(arena.live)}; prefix-mode dispatch would "
                    f"overwrite their KV at synthetic cursors — pass "
                    f"slots= (all live rows) instead"
                )
            cur, active = self._prefix_inputs(mid, seq, batch_size)
            if not arena.presented:
                # Synthetic cursors at seq-1: fill every ring as a served
                # row's is there, so the step (and the WCET profiled from
                # it) does a full window's attention, as a full cache's
                # validity by cursor already makes it do.
                ring_cache_present_window(arena.cache, seq - 1)
                arena.presented = True
        else:
            ids = [int(s) for s in slots]
            if len(ids) != batch_size or len(set(ids)) != len(ids):
                raise ValueError(
                    f"need {batch_size} distinct slot ids, got {ids}"
                )
            if set(ids) != set(arena.live):
                raise ValueError(
                    f"slot dispatch must step ALL live rows "
                    f"{sorted(arena.live)}, got {sorted(ids)}"
                )
            cur, active = arena.cur, arena.active
            if step_rows is not None:
                step = [int(s) for s in step_rows]
                extra = sorted(set(step) - set(ids))
                if extra:
                    raise ValueError(
                        f"step_rows {extra} are not live rows {sorted(ids)}"
                    )
                active = arena.active & self._row_mask(step)
        k = batch_size if self.masked_decode else m
        self.stats["real_rows"] += batch_size
        self.stats["bucket_rows"] += m
        self.stats["real_slots"] += batch_size * seq
        self.stats["total_slots"] += k * seq
        logits, _, new_cur = fn(self.params[mid], arena.cache, tok, cur, active)
        if slots is not None:
            arena.cur.copy_(new_cur)  # advanced on the device, in place
        handle = StepHandle(logits, mid, kind, batch_size, m, event=self._record())
        ring.attach_consumer(handle.wait)
        return handle

    def execute(
        self, mid: str, shape_key: Tuple[int, ...], batch_size: int,
        kind: str = "prefill", slots: Optional[Sequence[int]] = None,
        payload=None,
    ) -> float:
        """Run one batched job synchronously; returns wall seconds. The
        offline profiler path."""
        t0 = time.perf_counter()
        self.dispatch(
            mid, shape_key, batch_size, kind, slots=slots, payload=payload
        ).wait()
        return time.perf_counter() - t0

    # ----- accounting -----------------------------------------------------
    @property
    def staging_bytes(self) -> int:
        """Lifetime host->device payload bytes staged across all rings."""
        return sum(r.bytes_staged for r in self._rings.values())

    @property
    def staging_fills(self) -> int:
        return sum(r.fills for r in self._rings.values())

    @property
    def staging_host_allocs(self) -> int:
        """Host scratch buffers ever allocated (two per ring, forever)."""
        return sum(r.host_allocs for r in self._rings.values())

    def job_bytes(
        self, mid: str, shape_key: Tuple[int, ...], batch_size: int,
        kind: str = "prefill",
    ) -> float:
        """Bytes a running job pins on the device (staging + the arena it
        executes against; the device runs one job at a time, so the
        resident arena is charged to the in-flight decode job)."""
        seq = shape_key[0]
        if kind == "prefill":
            return float(4 * bucket(batch_size) * seq)  # int32 tokens
        staging = 3 * 4 * self.max_slots  # int32 tokens, cursors, active
        return float(staging + self.arena_nbytes(mid, seq))

    @property
    def padding_waste(self) -> float:
        """Measured fraction of attended decode KV slots spent on dead
        rows (0.0 under the masked arena: dead rows attend to nothing)."""
        if self.stats["total_slots"] == 0:
            return 0.0
        return max(0.0, 1.0 - self.stats["real_slots"] / self.stats["total_slots"])

    def telemetry(self) -> Dict[str, object]:
        """JSON-able execution-substrate snapshot: per-arena occupancy and
        allocator churn, staging-ring reuse, compile/dispatch counters."""
        arenas = {}
        for (mid, seq), arena in self._arenas.items():
            arenas[f"{mid}/seq{seq}"] = {
                "max_slots": arena.max_slots,
                "free": len(arena.free),
                "occupied": arena.max_slots - len(arena.free),
                "allocs": arena.allocs,
                "resets": arena.resets,
                "nbytes": self.arena_nbytes(mid, seq),
            }
        return {
            "arenas": arenas,
            "staging": {
                "rings": len(self._rings),
                "bytes": self.staging_bytes,
                "fills": self.staging_fills,
                "host_allocs": self.staging_host_allocs,
            },
            "stats": dict(self.stats),
            "padding_waste": self.padding_waste,
            "frozen": self.frozen,
            "device": str(self.device),
        }
