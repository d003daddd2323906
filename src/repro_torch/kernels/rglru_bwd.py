"""The backward of the RG-LRU recurrence: the Hopper kernel's wrapper.

The kernel is ``csrc/rglru_bwd.cu`` (its header says what it replaces,
what bounds it and how). ``rglru_bwd`` launches it on CUDA tensors and
raises on anything else; ``rglru_bwd_plain`` (``kernels/ref.py``) is the
same reverse-time recurrence written out in PyTorch, which CPU tensors
take and the kernel is held against. ``launches`` counts kernel calls.
``rglru.RGLRUScanFn`` calls it; nothing else on a model's path does.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import rglru_bwd_plain

NAME = "rglru_bwd"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib():
    fn = _build.load(NAME).rglru_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def rglru_bwd(
    a: torch.Tensor,  # (B, S, D) the forward's decay
    h: torch.Tensor,  # (B, S, D) the forward's output
    dh: torch.Tensor,  # (B, S, D) the gradient of h
    dh_last: Optional[torch.Tensor] = None,  # (B, D) float32; None = zeros
    h0: Optional[torch.Tensor] = None,  # (B, D) float32; None = zeros
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(da, db in a's dtype, dh0 float32) from the CUDA kernel. CUDA
    tensors only: raises otherwise."""
    global launches
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
    err = _lib()(
        _DTYPES[a.dtype], a.data_ptr(), h.data_ptr(), dh.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), None if h0 is None else h0.data_ptr(),
        da.data_ptr(), db.data_ptr(), dh0.data_ptr(), bsz, s, d,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rglru_bwd launch failed: cudaError {err}")
    launches += 1
    return da, db, dh0


__all__ = ["rglru_bwd", "rglru_bwd_plain", "launches"]
