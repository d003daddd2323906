"""Double-buffered host->device staging rings (the ingest byte path into
the engine).

Every dispatched step carries payload bytes that arrived moments
earlier. Allocating a fresh host array per step is allocator traffic on
the hot loop; reusing ONE buffer is a data race the instant the upload
is asynchronous. A ``StagingRing`` fixes both:

- ``depth`` host scratch buffers are allocated ONCE and cycled
  round-robin — steady-state staging performs ZERO fresh host
  allocations (``host_allocs`` stays equal to ``depth`` forever);
- fill and flight never share a buffer: job N fills (and uploads from)
  scratch ``N % depth``, job N+1 fills scratch ``(N+1) % depth``.

On a CUDA device the scratch buffers are PINNED host memory and
``stage`` returns ``scratch.to(device, non_blocking=True)``: the copy is
queued on the current stream and reads the host buffer AFTER ``stage``
has returned, whenever the stream reaches it. That makes the consumer
guard load-bearing, not belt-and-braces: the caller attaches each staged
buffer's consumer (the dispatched step's ``wait``), and ``stage`` waits
for a scratch's previous consumer before refilling it, so a refill never
overwrites bytes an in-flight copy has yet to read. On the CPU the
returned tensor shares the scratch's memory, which the same guard
protects. The EDF worker keeps at most one job in flight per device, so
``depth=2`` serves the hot path with the guard never blocking.

Byte accounting: ``fills`` / ``bytes_staged`` are the ring's lifetime
host->device traffic.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def check_payload_dtype(arr: np.ndarray, dtype: np.dtype) -> None:
    """Reject payloads whose dtype would be silently mangled by the
    staging cast (e.g. raw float frame data handed to an int32 token
    ring): only same-kind casts (int -> int) are accepted, so a
    malformed payload fails at the gateway boundary, not as garbage
    tokens inside a step."""
    if not np.can_cast(arr.dtype, dtype, casting="same_kind"):
        raise ValueError(
            f"payload dtype {arr.dtype} cannot safely stage as {dtype}"
        )


class StagingRing:
    """A fixed pool of host scratch buffers cycled round-robin.

    ``shape``/``dtype`` are the staged array's device shape — one ring per
    step input (the engine keys rings by ``(kind, mid, seq, batch)``).
    """

    def __init__(
        self,
        shape: Sequence[int],
        dtype=np.int32,
        depth: int = 2,
        device="cuda",
    ):
        if depth < 2:
            raise ValueError(
                f"staging ring depth must be >= 2 (fill + in-flight), got {depth}"
            )
        self.shape: Tuple[int, ...] = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)
        self.depth = depth
        self.device = torch.device(device)
        pinned = self.device.type == "cuda"
        tdtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        self._host = [
            torch.zeros(self.shape, dtype=tdtype, pin_memory=pinned)
            for _ in range(depth)
        ]
        # numpy views of the (pinned) host tensors: fills write through.
        self._scratch = [t.numpy() for t in self._host]
        self._next = 0
        self._last_slot: Optional[int] = None
        # Per-scratch consumer guard: wait callables for the job that
        # last consumed each buffer (see ``attach_consumer``).
        self._consumers: list = [None] * depth
        # Lifetime counters (the reuse / traffic acceptance bars).
        self.host_allocs = depth  # never grows after construction
        self.fills = 0
        self.bytes_staged = 0
        self.consumer_waits = 0  # guard invocations before a refill

    @property
    def capacity(self) -> int:
        """Stages that may be in flight behind ONE consumer: depth - 1.

        A multi-step decode chunk stages one ring slot per step and
        attaches the SAME consumer (the chunk's completion) to each, so a
        k-step chunk needs ``k <= capacity``: were k to reach depth, the
        k-th stage would wrap onto a slot whose guard is the chunk's own
        not-yet-dispatched wait. The engine sizes decode rings to
        ``max_chunk_depth + 1`` and checks this at dispatch.
        """
        return self.depth - 1

    def stage(self, fill_fn: Callable[[np.ndarray], None]) -> torch.Tensor:
        """Fill the next scratch buffer in place and upload it.

        If a consumer is attached to this scratch (a step dispatched
        ``depth`` fills ago), its ``wait`` runs FIRST — the refill never
        races a copy or a step still reading the buffer. ``fill_fn(scratch)``
        must write the COMPLETE buffer contents it cares about (the
        scratch still holds the bytes from ``depth`` fills ago). Returns
        the device tensor the step consumes.
        """
        slot = self._next
        self._next = (slot + 1) % self.depth
        guard = self._consumers[slot]
        if guard is not None:
            self._consumers[slot] = None
            self.consumer_waits += 1
            guard()
        buf = self._scratch[slot]
        fill_fn(buf)
        self.fills += 1
        self.bytes_staged += buf.nbytes
        self._last_slot = slot
        return self._host[slot].to(self.device, non_blocking=True)

    def attach_consumer(self, wait_fn: Callable[[], object]) -> None:
        """Register the consumer of the MOST RECENTLY staged buffer.

        ``wait_fn`` must block until the consuming step has finished
        reading the staged input (the engine passes the dispatched
        ``StepHandle.wait``, which synchronizes on an event recorded after
        the step — by then the copy and the step are done). The guard
        runs at most once, on the fill that wants the scratch back.
        """
        if self._last_slot is None:
            raise RuntimeError("attach_consumer before any stage()")
        self._consumers[self._last_slot] = wait_fn

    def stage_rows(
        self, rows: Optional[np.ndarray], n_rows: int
    ) -> torch.Tensor:
        """Stage ``rows`` into the leading ``n_rows`` slots, zero the rest.

        ``rows=None`` stages an all-zero buffer (the profiler's payload).
        Raises on shape/dtype mismatches so a malformed payload fails at
        the gateway boundary, not as silent garbage tokens inside a step.
        """
        if n_rows < 0 or n_rows > self.shape[0]:
            raise ValueError(
                f"n_rows {n_rows} outside staged batch axis {self.shape[0]}"
            )
        arr: Optional[np.ndarray] = None
        if rows is not None:
            arr = np.asarray(rows)
            if arr.shape != (n_rows,) + self.shape[1:]:
                raise ValueError(
                    f"payload shape {arr.shape} != expected "
                    f"{(n_rows,) + self.shape[1:]} for ring {self.shape}"
                )
            check_payload_dtype(arr, self.dtype)

        def fill(buf: np.ndarray) -> None:
            if arr is None:
                buf[:] = 0
                return
            buf[:n_rows] = arr.astype(self.dtype, copy=False)
            buf[n_rows:] = 0

        return self.stage(fill)
