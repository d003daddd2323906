"""Flash attention (prefill): the Hopper kernel's wrapper.

The kernel is ``csrc/flash_attention.cu`` (its header says what it
replaces, what bounds it and how). ``flash_attention`` launches it on a
CUDA tensor and raises on anything else; ``flash_attention_plain`` is the
plain PyTorch version that ``ops`` runs for CPU tensors and that the
kernel is held against. ``launches`` counts kernel launches.

Positions are arange (left-aligned prefill); keys at or past ``S`` do not
exist, a causal query attends to keys ``<= `` its position, a window of
``w`` keeps keys ``> position - w``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

NAME = "flash_attention"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p]
)


def _lib():
    lib = _build.load(NAME)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel. CUDA tensors only: raises otherwise."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention supports float32/bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q/k must be 4-d, got {tuple(q.shape)} / {tuple(k.shape)}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d} must be a multiple of 8 up to 256")
    dev = q.device
    _check("q", q, (b, s, h, d), q.dtype, dev)
    _check("k", k, (b, s, kv, d), q.dtype, dev)
    _check("v", v, (b, s, kv, d), q.dtype, dev)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    fn = _lib()
    err = fn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, kv, d, int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return out


__all__ = ["flash_attention", "flash_attention_plain", "launches"]
