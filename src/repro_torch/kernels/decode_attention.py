"""Decode (single-token) attention: the Hopper kernel's wrapper.

The kernel is ``csrc/decode_attention.cu`` (its header says what it
replaces, what bounds it and how). ``decode_attention`` launches it on a
CUDA tensor and raises on anything else; ``decode_attention_plain`` is
the plain PyTorch version that ``ops`` runs for CPU tensors and that the
kernel is held against. ``launches`` counts kernel launches.

Semantics (shared with the plain version): slot ``s`` of row ``b`` is
live when ``kv_pos <= cursor & kv_valid & active`` (and
``kv_pos > cursor - window`` under a window); a row with no live slot
outputs exact 0.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref as decode_attention_plain

NAME = "decode_attention"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p]
)


def _lib():
    lib = _build.load(NAME)
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    cache_k: torch.Tensor,  # (B, S, KV, D)
    cache_v: torch.Tensor,
    cursor: torch.Tensor,  # (B,) int32
    kv_pos: torch.Tensor,  # (B, S) int32
    kv_valid: torch.Tensor,  # (B, S) bool
    active: Optional[torch.Tensor] = None,  # (B,) bool; None = all live
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel. CUDA tensors only: raises otherwise."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention supports float32/bfloat16, got {q.dtype}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if cache_k.dim() != 4:
        raise ValueError(f"cache_k must be (B, S, KV, D), got {tuple(cache_k.shape)}")
    s, kv = cache_k.shape[1], cache_k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d} must be a multiple of 8 up to 256")
    dev = q.device
    _check("q", q, (b, 1, h, d), q.dtype, dev)
    _check("cache_k", cache_k, (b, s, kv, d), q.dtype, dev)
    _check("cache_v", cache_v, (b, s, kv, d), q.dtype, dev)
    _check("cursor", cursor, (b,), torch.int32, dev)
    _check("kv_pos", kv_pos, (b, s), torch.int32, dev)
    _check("kv_valid", kv_valid, (b, s), torch.bool, dev)
    if active is not None:
        _check("active", active, (b,), torch.bool, dev)
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    fn = _lib()
    err = fn(
        _DTYPES[q.dtype], q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        cursor.data_ptr(), kv_pos.data_ptr(), kv_valid.data_ptr(),
        None if active is None else active.data_ptr(), out.data_ptr(),
        b, s, kv, h // kv, d, 0 if window is None else int(window),
        1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    launches += 1
    return out


__all__ = ["decode_attention", "decode_attention_plain", "launches"]
