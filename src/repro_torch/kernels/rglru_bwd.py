"""The backward of the RG-LRU recurrence: the Hopper kernel's wrapper.

The kernel is ``csrc/rglru_bwd.cu`` (its header says what it replaces,
what bounds it and how). ``rglru_bwd`` launches it on CUDA tensors and
raises on anything else; ``rglru_bwd_plain`` (``kernels/ref.py``) is the
same reverse-time recurrence written out in PyTorch, which CPU tensors
take and the kernel is held against. ``launches`` counts kernel calls
(a chunked call is three CUDA launches and counts one).
``rglru.RGLRUScanFn`` calls it; nothing else on a model's path does.

The route is the forward's (``rglru.uses_chunked`` and
``rglru.plan_chunks`` on the same shape): streaming, bit for bit the
plain version in float32, or chunked, whose plain twin is
``ref.rglru_bwd_chunked_plain``. ``previous_design`` runs the streaming
kernel on any shape, for timing in turns only; it is not counted.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rglru as _fwd
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import rglru_bwd_plain

NAME = "rglru_bwd"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = {
    "rglru_scan_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "rglru_scan_chunked_bwd": [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def _fn(symbol: str):
    fn = getattr(_build.load(NAME), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _launch(a, h, dh, dh_last, h0, plan):
    """Check the arguments and run one call of the backward kernel: the
    chunked route with ``plan = (chunk length, chunks)``, else streaming."""
    if a.device.type != "cuda":
        raise ValueError(f"rglru_bwd kernel needs CUDA tensors, got {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"rglru_bwd supports float32/bfloat16, got {a.dtype}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, D), got {tuple(a.shape)}")
    bsz, s, d = a.shape
    if s < 1 or not 1 <= bsz <= 65535:
        raise ValueError(f"rglru_bwd takes S >= 1 and 1 <= B <= 65535, got {tuple(a.shape)}")
    dev = a.device
    for name, t in (("a", a), ("h", h), ("dh", dh)):
        _check(name, t, (bsz, s, d), a.dtype, dev)
    for name, t in (("dh_last", dh_last), ("h0", h0)):
        if t is not None:
            _check(name, t, (bsz, d), torch.float32, dev)
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((bsz, d), dtype=torch.float32, device=dev)
    ptrs = (a.data_ptr(), h.data_ptr(), dh.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(),
            None if h0 is None else h0.data_ptr(), da.data_ptr(), db.data_ptr(), dh0.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan is None:
        err = _fn("rglru_scan_bwd")(_DTYPES[a.dtype], *ptrs, bsz, s, d, stream)
    else:
        # Scratch: each walk chunk's (P, E), then E's slots hold the carries.
        chunk, n = plan
        scratch = torch.empty(2 * bsz * n * d, dtype=torch.float32, device=dev)
        p = scratch.data_ptr()
        err = _fn("rglru_scan_chunked_bwd")(_DTYPES[a.dtype], *ptrs, p, p + 4 * bsz * n * d,
                                            bsz, s, d, chunk, stream)
    if err:
        raise RuntimeError(f"rglru_bwd launch failed: cudaError {err}")
    return da, db, dh0


def rglru_bwd(
    a: torch.Tensor,  # (B, S, D) the forward's decay
    h: torch.Tensor,  # (B, S, D) the forward's output
    dh: torch.Tensor,  # (B, S, D) the gradient of h
    dh_last: Optional[torch.Tensor] = None,  # (B, D) float32; None = zeros
    h0: Optional[torch.Tensor] = None,  # (B, D) float32; None = zeros
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(da, db in a's dtype, dh0 float32) from the CUDA kernel of the
    forward's route for this shape. CUDA tensors only: raises otherwise."""
    global launches
    out = _launch(a, h, dh, dh_last, h0, _fwd.route(a))
    launches += 1
    return out


def previous_design(a, h, dh, dh_last=None, h0=None):
    """The streaming kernel on any shape (the only design before the
    chunked one), for timing in turns. Not counted in ``launches``."""
    return _launch(a, h, dh, dh_last, h0, None)


__all__ = ["rglru_bwd", "rglru_bwd_plain", "launches", "previous_design"]
