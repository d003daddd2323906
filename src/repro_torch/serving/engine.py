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
- In place of XLA's compiled programs, each decode step (per (mid, seq))
  is ONE CUDA graph on a CUDA device. A key's first call runs eagerly as
  that call's real step (it also loads the kernel libraries and cuBLAS's
  handles); the graph is captured right after it, which runs no kernel
  and leaves the arena as the eager step left it. Every later call copies
  its inputs (tokens, cursors, active bitmap) into the graph's static
  buffers on the replaying stream, replays, and clones the logits out,
  so no handle's outputs are overwritten by the next replay. The graph
  reads and writes the arena at the captured addresses, so the arena and
  the parameters are never rebound. ``stats["decode_compiles"]`` counts
  captures (on the CPU, step and chunk builds) and stays 0 after
  warm-up; a failed capture raises, with no eager path behind it.
  Prefill stays eager.
- ``decode_chunk`` runs k decode steps as one dispatch: the single step
  repeated in order (the reference's ``lax.scan``), bit-identical to k
  single-step dispatches. On a CUDA device that is k back-to-back
  replays of the (mid, seq) step graph on one stream (one graph of k
  steps would leave the device waiting on the host's launch of its
  thousands of nodes), each step's logits copied into the chunk's own
  output before the next replay overwrites them.
- Parameters are made ON THE DEVICE, in each config's ``param_dtype``,
  from a ``torch.Generator`` on that device seeded from ``seed``;
  callers may pass ready parameters instead (``params=``).
- Inputs are staged through ``StagingRing``s (pinned host buffers,
  non-blocking copies) guarded by the step that consumes them.

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
from repro_torch.kernels import ops as kernel_ops
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

    outputs: Any  # prefill -> next tokens (b,); decode -> logits (m, V); chunk (k, m, V)
    mid: str
    kind: str
    true_batch: int
    bucket_batch: int  # prefill: the pow2 bucket; decode: max_slots
    steps: int = 1  # decode steps this dispatch executed (chunk depth)
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


class _DecodeGraph:
    """One decode step captured as a CUDA graph: the static input buffers
    it reads, the static outputs it writes, and the kernel launches one
    replay makes, by wrapper (what the wrappers counted while it was
    captured)."""

    def __init__(self, fn, args: Sequence[torch.Tensor], pool):
        self.inputs = [a.clone() for a in args]
        self.graph = torch.cuda.CUDAGraph()
        before = kernel_ops.launch_counts()
        try:
            # thread_local: the capturing thread may make no call that is
            # unsafe under capture (a hidden sync in the step raises here),
            # while other threads (an AsyncDevice waiter synchronizing on
            # an earlier step's event) are not made to fail by it, as
            # "global" would. Captures happen during profiling anyway.
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.outputs = fn(*self.inputs)
        finally:
            after = kernel_ops.launch_counts()
            self.launches = {n: after[n] - before[n] for n in after}
            # Capture launched nothing: take back what the wrappers counted.
            kernel_ops.add_launch_counts({n: -d for n, d in self.launches.items()})

    def replay(self, args: Sequence[torch.Tensor]):
        """Copy ``args`` into the static inputs and replay, all on the
        current stream; returns the static outputs (valid until the next
        replay)."""
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        kernel_ops.add_launch_counts(self.launches)
        return self.outputs


def _steps_in_order(step, toks, cur, active, masks):
    """k decode steps of ``step`` in order, eagerly: step i consumes
    ``toks[i]`` with ``active & masks[i]`` and the cursors step i-1 left.
    Returns the (k, m, V) logits and the final cursors."""
    logits = []
    for i in range(toks.shape[0]):
        lg, cur = step(toks[i], cur, active & masks[i])
        logits.append(lg)
    return torch.stack(logits), cur


# Cached device row masks (``InferenceEngine._row_mask``) kept at most.
ROW_MASK_CACHE = 4096
# Host scratch buffers per staging ring: one filled while the device
# reads another (decode rings grow to a chunk's depth + 1).
STAGING_DEPTH = 2


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
        arena rows per (model, seq). ``chunk_depth``: the deepest decode
        chunk this engine serves; a k-step chunk stages one decode ring
        slot per step behind one consumer, so decode rings hold
        ``max(STAGING_DEPTH, chunk_depth + 1)`` buffers. ``device``:
        ``"cuda"`` (the default) or ``"cpu"``. ``params``: ready parameter
        trees by model id (e.g. from ``repro_torch.interop``); other
        models are drawn from the seeded generator.
        """
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if chunk_depth < 1:
            raise ValueError(f"chunk_depth must be >= 1, got {chunk_depth}")
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
        # Decode graphs by step key, all in one memory pool: replays run
        # one at a time on one stream and outputs are cloned out, so no
        # graph's memory is live while another replays.
        self._graphs: Dict[Tuple, _DecodeGraph] = {}
        self._graph_pool = (
            torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        )
        self._arenas: Dict[Tuple[str, int], SlotArena] = {}
        self.max_chunk_depth = chunk_depth
        self._rings: Dict[Tuple, StagingRing] = {}
        # Device row masks by sorted row ids, and all-rows step masks by
        # chunk depth: read-only, so a step re-sends resident tensors.
        self._row_masks: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._full_masks: Dict[int, torch.Tensor] = {}
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
        only served traffic — ``decode_compiles`` then counts decode
        captures AFTER warm-up, which the slot arena holds at 0."""
        self.stats.update(
            real_rows=0, bucket_rows=0, real_slots=0, total_slots=0,
            dispatches=0, decode_compiles=0, prefill_compiles=0,
            chunk_steps=0,
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

    def stream_mark(self) -> Optional[Any]:
        """A CUDA event recorded on the current stream ahead of the next
        dispatch's launches (None on the CPU): ``AsyncDevice`` starts a
        job's clocks once the stream has reached it."""
        return self._record()

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

    def _decode_body(self, mid: str, seq: int):
        """The decode step's body for (mid, seq) on its arena:
        ``run(tok, cur, active) -> (logits, new_cur)`` also advances the
        active rows' cursors (clamped at the cache edge; a real system
        would evict)."""
        model, params = self.models[mid], self.params[mid]
        cache = self.arena(mid, seq).cache

        def run(tok, cur, active):
            with torch.no_grad():
                logits, _ = model.decode_step(params, cache, tok, cur, active=active)
                return logits, torch.where(active, (cur + 1).clamp_(max=seq - 1), cur)

        return run

    def _decode_fn(self, mid: str, seq: int):
        """THE decode step for (mid, seq) on its arena: every live batch
        <= max_slots runs it (``_decode_body``)."""
        key = ("decode", mid, seq)
        if key not in self._steps:
            # One build per key, captured at its first call on a CUDA device.
            self.stats["decode_compiles"] += 1
            self._steps[key] = self._decode_body(mid, seq)
        return self._steps[key]

    def _decode_chunk_fn(self, mid: str, seq: int, k: int):
        """THE k-step decode chunk for (mid, seq, k) on the CPU: the single
        step's body called k times in order, as the reference's
        ``lax.scan``. ``run(toks (k, m), cur, active, masks (k, m)) ->
        (logits (k, m, V), new_cur)``; step i runs with ``act = active &
        masks[i]``, so only rows set in ``act`` advance their cursor. Being
        k calls of the step makes the chunk bit-identical to k single steps
        (a contract, tests/test_torch_decode_chunking.py)."""
        key = ("decode_chunk", mid, seq, k)
        if key not in self._steps:
            self.stats["decode_compiles"] += 1
            step = self._decode_body(mid, seq)
            self._steps[key] = lambda *args: _steps_in_order(step, *args)
        return self._steps[key]

    def _run_decode(self, key: Tuple, fn, args: Sequence[torch.Tensor]):
        """Run one decode step; returns (logits, new_cur), the logits the
        caller's own. On the CPU ``fn`` runs eagerly. On a CUDA device a
        key's first call runs eagerly as that call's real step and its
        graph is captured after it; later calls replay the graph."""
        graph = self._graphs.get(key)
        if graph is not None:
            logits, new_cur = graph.replay(args)
            return logits.clone(), new_cur
        out = fn(*args)
        if self.device.type == "cuda":
            self._graphs[key] = _DecodeGraph(fn, args, self._graph_pool)
        return out

    def _run_chunk(self, mid: str, seq: int, k: int, toks, cur, active, masks):
        """Run one k-step chunk; returns ((k, m, V) logits, new_cur). On
        the CPU the eager loop ``_decode_chunk_fn``. On a CUDA device, k
        back-to-back replays of the (mid, seq) step graph on the current
        stream: before replay i its static inputs take step i's tokens,
        the running cursors (replay i-1's static ``new_cur``) and
        ``active & masks[i]``; after it, its static logits are copied into
        the chunk's output. A key with no step graph yet runs its k steps
        eagerly, and the step graph is captured after them."""
        if self.device.type != "cuda":
            return self._decode_chunk_fn(mid, seq, k)(toks, cur, active, masks)
        key = ("decode", mid, seq)
        acts = active & masks
        graph = self._graphs.get(key)
        if graph is None:
            step = self._decode_fn(mid, seq)
            logits, new_cur = _steps_in_order(step, toks, cur, active, masks)
            self._graphs[key] = _DecodeGraph(
                step, (toks[-1], new_cur, acts[-1]), self._graph_pool)
            return logits, new_cur
        static_logits = graph.outputs[0]
        out = static_logits.new_empty((k,) + tuple(static_logits.shape))
        for i in range(k):
            lg, cur = graph.replay((toks[i], cur, acts[i]))
            out[i].copy_(lg)
        return out, cur

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
        """(max_slots,) bool device mask of the rows ``ids``, read-only.
        Cached by row set, so a step between two replays re-sends a
        resident tensor; a new set is staged from pinned memory with a
        non-blocking copy (PyTorch's pinned allocator keeps the buffer
        until the copy has read it)."""
        key = tuple(sorted(set(int(i) for i in ids)))
        mask = self._row_masks.get(key)
        if mask is None:
            rows = torch.zeros(
                (self.max_slots,), dtype=torch.bool,
                pin_memory=self.device.type == "cuda",
            )
            if key:
                rows[list(key)] = True
            mask = rows.to(self.device, non_blocking=True)
            if len(self._row_masks) >= ROW_MASK_CACHE:
                self._row_masks.clear()
            self._row_masks[key] = mask
        return mask

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
            # The EDF worker keeps one job in flight, so one scratch is read
            # by the device while another is filled. A decode chunk stages
            # one slot per step behind one consumer, plus the fill target;
            # a ring's depth is fixed at creation, so it is sized here.
            depth = STAGING_DEPTH
            if kind == "decode":
                depth = max(depth, self.max_chunk_depth + 1)
            ring = StagingRing(shape, np.int32, depth=depth, device=self.device)
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
            cur, active = self._prefix_mode_inputs(mid, seq, batch_size, "dispatch")
        else:
            ids = self._check_slots(arena, slots, batch_size)
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
        logits, new_cur = self._run_decode(("decode", mid, seq), fn, (tok, cur, active))
        if slots is not None:
            arena.cur.copy_(new_cur)  # advanced on the device, in place
        handle = StepHandle(logits, mid, kind, batch_size, m, event=self._record())
        ring.attach_consumer(handle.wait)
        return handle

    def _prefix_mode_inputs(
        self, mid: str, seq: int, batch_size: int, op: str
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cursors, active) of a prefix-mode step, which needs an arena
        with no allocator-live row; presents its rings first."""
        arena = self.arena(mid, seq)
        if len(arena.free) != arena.max_slots:
            raise ValueError(
                f"arena {mid}/seq={seq} has allocator-live rows "
                f"{sorted(arena.live)}; prefix-mode {op} would "
                f"overwrite their KV at synthetic cursors — pass "
                f"slots= (all live rows) instead"
            )
        if not arena.presented:
            # Synthetic cursors at seq-1: fill every ring as a served
            # row's is there, so the step (and the WCET profiled from
            # it) does a full window's attention, as a full cache's
            # validity by cursor already makes it do.
            ring_cache_present_window(arena.cache, seq - 1)
            arena.presented = True
        return self._prefix_inputs(mid, seq, batch_size)

    @staticmethod
    def _check_slots(arena: SlotArena, slots: Sequence[int], batch_size: int) -> List[int]:
        """The slot ids of a slot-mode step: ``batch_size`` distinct ids,
        exactly the arena's live rows."""
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
        return ids

    def decode_chunk(
        self, mid: str, shape_key: Tuple[int, ...], batch_size: int, k: int,
        slots: Optional[Sequence[int]] = None,
        payloads: Optional[Sequence] = None,
        step_rows: Optional[Sequence[Optional[Sequence[int]]]] = None,
    ) -> StepHandle:
        """Enqueue ONE k-step decode chunk without waiting for the device.

        The chunked twin of a decode ``dispatch``: the same slot-arena
        semantics (``slots`` must be ALL live rows; prefix mode when
        ``slots=None``), executed k steps deep by ``_run_chunk`` (k replays
        of the step graph on the card): bit-identical to k sequential
        single-step dispatches, with the k-1 intermediate host returns
        removed. The handle's outputs are the (k, max_slots, V) logits.

        ``payloads``: length-k sequence of per-step decode payloads (each
        in any form single-step ``dispatch`` accepts); ``None`` = all
        steps zero-staged (the profiler's input). Each step's tokens go
        through the SAME decode staging ring, one slot per step, all
        guarded by this chunk's completion, so ``k`` must not exceed
        ``ring.capacity`` (sized from ``chunk_depth`` at construction; a
        deeper chunk is rejected rather than left to deadlock on its own
        not-yet-dispatched consumer).

        ``step_rows``: length-k sequence of per-step frame-bearing row
        subsets (``None`` entry = every live row steps). Idle leased rows
        at step i run masked: attention skipped, cursor frozen, as with
        single-step ``step_rows``.
        """
        self._check_not_frozen("decode_chunk")
        seq = shape_key[0]
        m = self.max_slots
        if k < 1:
            raise ValueError(f"chunk depth must be >= 1, got {k}")
        if batch_size > m:
            raise ValueError(
                f"decode batch {batch_size} > max_slots {m}: size the "
                f"arena via bucketing.arena_slots at engine build"
            )
        if payloads is not None and len(payloads) != k:
            raise ValueError(
                f"chunk of depth {k} needs {k} per-step payloads, "
                f"got {len(payloads)}"
            )
        if step_rows is not None and len(step_rows) != k:
            raise ValueError(
                f"chunk of depth {k} needs {k} per-step row sets, "
                f"got {len(step_rows)}"
            )
        arena = self.arena(mid, seq)
        ring = self.staging_ring("decode", mid, seq, m)
        if k > ring.capacity:
            raise ValueError(
                f"chunk depth {k} exceeds the decode ring's in-flight "
                f"capacity {ring.capacity}: build the engine with "
                f"chunk_depth >= {k}"
            )
        if slots is None:
            cur, active = self._prefix_mode_inputs(mid, seq, batch_size, "decode_chunk")
        else:
            ids = self._check_slots(arena, slots, batch_size)
            cur, active = arena.cur, arena.active
            for i, rows_i in enumerate(step_rows or ()):
                if rows_i is None:
                    continue
                extra = sorted(set(int(s) for s in rows_i) - set(ids))
                if extra:
                    raise ValueError(
                        f"step {i} rows {extra} are not live rows {sorted(ids)}"
                    )
        # Per-step token staging: one ring slot per step, every slot
        # guarded by THIS chunk's completion (the guard resolves the handle
        # after dispatch; a later refill of any of these scratches waits
        # until this chunk finished reading it).
        pending: Dict[str, Optional[StepHandle]] = {"handle": None}

        def _chunk_guard() -> None:
            h = pending["handle"]
            if h is not None:
                h.wait()

        staged = []
        prefix = batch_size if slots is None else None
        for i in range(k):
            payload_i = payloads[i] if payloads is not None else None
            staged.append(self._stage_decode_tokens(ring, payload_i, prefix_rows=prefix))
            ring.attach_consumer(_chunk_guard)
        toks = torch.stack(staged)
        masks = self._step_masks(k, step_rows)
        kk = batch_size if self.masked_decode else m
        self.stats["dispatches"] += 1
        self.stats["chunk_steps"] += k
        self.stats["real_rows"] += batch_size * k
        self.stats["bucket_rows"] += m * k
        self.stats["real_slots"] += batch_size * seq * k
        self.stats["total_slots"] += kk * seq * k
        logits, new_cur = self._run_chunk(mid, seq, k, toks, cur, active, masks)
        if slots is not None:
            arena.cur.copy_(new_cur)
        handle = StepHandle(logits, mid, "decode", batch_size, m, steps=k,
                            event=self._record())
        pending["handle"] = handle
        return handle

    def _step_masks(
        self, k: int, step_rows: Optional[Sequence[Optional[Sequence[int]]]]
    ) -> torch.Tensor:
        """The (k, max_slots) per-step frame mask a chunk consumes, made on
        the device from resident tensors: the all-rows mask per depth, or
        each step's cached row mask."""
        m = self.max_slots
        if step_rows is None or all(r is None for r in step_rows):
            if k not in self._full_masks:
                self._full_masks[k] = torch.ones((k, m), dtype=torch.bool, device=self.device)
            return self._full_masks[k]
        every = self._row_mask(range(m))
        return torch.stack([every if r is None else self._row_mask(r) for r in step_rows])

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

    def execute_chunk(
        self, mid: str, shape_key: Tuple[int, ...], batch_size: int, k: int,
        slots: Optional[Sequence[int]] = None,
        payloads: Optional[Sequence] = None,
    ) -> float:
        """Run one k-step decode chunk synchronously; returns wall
        seconds. The offline profiler's per-depth measurement path."""
        t0 = time.perf_counter()
        self.decode_chunk(
            mid, shape_key, batch_size, k, slots=slots, payloads=payloads
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
        kind: str = "prefill", steps: int = 1,
    ) -> float:
        """Bytes a running job pins on the device (staging + the arena it
        executes against; the device runs one job at a time, so the
        resident arena is charged to the in-flight decode job)."""
        seq = shape_key[0]
        if kind == "prefill":
            return float(4 * bucket(batch_size) * seq)  # int32 tokens
        # steps > 1: a chunk stages one token vector per step (plus the
        # (steps, max_slots) bool step-mask plane) on top of the shared
        # cursors/active pair; steps == 1 is the classic tok+cur+active.
        staging = (2 + steps) * 4 * self.max_slots
        if steps > 1:
            staging += steps * self.max_slots
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
