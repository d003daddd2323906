"""RG-LRU linear recurrence: the Hopper kernel's wrapper.

The kernel is ``csrc/rglru.cu`` (its header says what it replaces, what
bounds it and how). ``rglru_scan`` launches it on CUDA tensors and raises
on anything else; ``rglru_scan_plain`` is the plain PyTorch version that
``ops`` runs for CPU tensors and that the kernel is held against.
``launches`` counts calls that launched a kernel: one per call, though
a chunked call is three CUDA launches.

Two designs, chosen by ``uses_chunked(B, S, D, SMs)`` alone, so one shape
on one card always takes one route:

- **streaming** (the B x D channels fill the card, as the served prefill's
  8 x 4096 do, or S is too short to cut): one thread per (b, channel)
  walking time. Its float32 results are the plain version's bit for bit.
- **chunked** (too few channels for the card, as training's 1 x 4096):
  time cut into chunks that ``plan_chunks`` sizes, their summaries, the
  carries between them, then each chunk's walk from its carry; three CUDA
  launches in a fixed order. ``ref.rglru_chunked_plain`` is the plain twin
  of its arithmetic; only the carries round differently from the
  sequential walk.

``previous_design`` runs the streaming kernel on any shape, for timing in
turns only; it is not counted in ``launches``.

Gradients: when autograd is recording and a, b or h0 requires a
gradient, ``rglru_scan`` runs ``RGLRUScanFn``: its forward is the same
kernel and saves a, h and h0; its backward is the hand-written backward
kernel (``rglru_bwd.py``, counted there). Otherwise the call saves
nothing, so serving is unchanged.

Channel-wise ``h_t = a_t h_{t-1} + b_t`` from ``h0`` (zeros when absent);
a and b share one dtype (float32 or bfloat16); h comes out in a's dtype,
the last h in float32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rglru_bwd as _bwd
from repro_torch.kernels.decode_attention import _check, _sm_count
from repro_torch.kernels.ref import rglru_ref as rglru_scan_plain

NAME = "rglru"
TILE = 128  # channels per block (kThreads in the sources)
CHUNKS = (256, 128, 64, 32, 16)  # plan_chunks' lengths, multiples of kUnroll = 8
BLOCKS_PER_SM = 4  # the chunked grid's aim: this many blocks on each SM
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = {
    "rglru_scan_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "rglru_scan_chunked_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def _fn(symbol: str):
    fn = getattr(_build.load(NAME), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def plan_chunks(b: int, s: int, d: int, sm_count: int) -> Tuple[int, int]:
    """``(chunk length, chunks)`` of the chunked route for a (b, s, d)
    call: the longest of ``CHUNKS`` whose grid of (channel tiles x chunks
    x b) blocks reaches ``BLOCKS_PER_SM`` per SM, else the shortest. The
    backward cuts its reversed walk the same way. A pure function."""
    tiles = -(-d // TILE)
    for chunk in CHUNKS:
        if tiles * b * -(-s // chunk) >= BLOCKS_PER_SM * sm_count:
            break
    return chunk, -(-s // chunk)


def uses_chunked(b: int, s: int, d: int, sm_count: int) -> bool:
    """Whether a (b, s, d) call takes the chunked route (else the
    streaming one): when the streaming grid's (channel tiles x b) blocks
    fall short of one per SM and the plan cuts S into two chunks or more.
    A pure function; the backward (``rglru_bwd``) follows the same rule."""
    return -(-d // TILE) * b < sm_count and plan_chunks(b, s, d, sm_count)[1] >= 2


def route(a: torch.Tensor) -> Optional[Tuple[int, int]]:
    """The plan of a call on the card with a of ``a``'s shape: ``(chunk
    length, chunks)`` on the chunked route, None on the streaming one.
    Raises for a tensor that is not on the card."""
    if a.device.type != "cuda":
        raise ValueError(f"the rglru kernels need CUDA tensors, got {a.device}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, D), got {tuple(a.shape)}")
    b, s, d = a.shape
    sms = _sm_count(a.device)
    return plan_chunks(b, s, d, sms) if uses_chunked(b, s, d, sms) else None


def _launch(a, b, h0, plan):
    """Check the arguments and run one call of the forward kernel: the
    chunked route with ``plan = (chunk length, chunks)``, else streaming."""
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan kernel needs CUDA tensors, got {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"rglru_scan supports float32/bfloat16, got {a.dtype}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, D), got {tuple(a.shape)}")
    bsz, s, d = a.shape
    if s < 1 or not 1 <= bsz <= 65535:
        raise ValueError(f"rglru_scan takes S >= 1 and 1 <= B <= 65535, got {tuple(a.shape)}")
    dev = a.device
    _check("a", a, (bsz, s, d), a.dtype, dev)
    _check("b", b, (bsz, s, d), a.dtype, dev)
    if h0 is not None:
        _check("h0", h0, (bsz, d), torch.float32, dev)
    out = torch.empty_like(a)
    h_last = torch.empty((bsz, d), dtype=torch.float32, device=dev)
    ptrs = (a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(), out.data_ptr(),
            h_last.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan is None:
        err = _fn("rglru_scan_fwd")(_DTYPES[a.dtype], *ptrs, bsz, s, d, stream)
    else:
        # Scratch: each chunk's (P, E), then E's slots hold the carries.
        chunk, n = plan
        scratch = torch.empty(2 * bsz * n * d, dtype=torch.float32, device=dev)
        p = scratch.data_ptr()
        err = _fn("rglru_scan_chunked_fwd")(_DTYPES[a.dtype], *ptrs, p, p + 4 * bsz * n * d,
                                            bsz, s, d, chunk, stream)
    if err:
        raise RuntimeError(f"rglru_scan launch failed: cudaError {err}")
    return out, h_last


class RGLRUScanFn(torch.autograd.Function):
    """The kernel with a gradient: forward saving a, h and h0, backward by
    the backward kernel (h_{t-1} read from the saved h)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        global launches
        out, h_last = _launch(a, b, h0, route(a))
        launches += 1
        ctx.save_for_backward(a, out, h0)
        ctx.set_materialize_grads(False)
        return out, h_last

    @staticmethod
    def backward(ctx, dout, dh_last):
        a, out, h0 = ctx.saved_tensors
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        da, db, dh0 = _bwd.rglru_bwd(a, out, dout,
                                     None if dh_last is None else dh_last.contiguous(), h0)
        return da, db, None if h0 is None else dh0


def rglru_scan(
    a: torch.Tensor,  # (B, S, D) decay in (0, 1)
    b: torch.Tensor,  # (B, S, D) inputs
    h0: Optional[torch.Tensor] = None,  # (B, D) float32; None = zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel of the route ``uses_chunked`` picks. CUDA
    tensors only: raises otherwise. Through ``RGLRUScanFn`` when a
    gradient is required of a, b or h0."""
    global launches
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (a, b, h0)):
        return RGLRUScanFn.apply(a, b, h0)
    out = _launch(a, b, h0, route(a))
    launches += 1
    return out


def previous_design(a, b, h0=None):
    """The streaming kernel on any shape (the only design before the
    chunked one), for timing in turns. Not counted in ``launches``."""
    return _launch(a, b, h0, None)


__all__ = ["RGLRUScanFn", "rglru_scan", "rglru_scan_plain", "launches", "plan_chunks",
           "uses_chunked", "route", "previous_design"]
