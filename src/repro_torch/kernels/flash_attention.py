"""Flash attention (prefill): the Hopper kernel's wrapper.

The kernel is ``csrc/flash_attention.cu`` (its header says what it
replaces, what bounds it and how). ``flash_attention`` launches it on a
CUDA tensor and raises on anything else; ``flash_attention_plain`` is the
plain PyTorch version that ``ops`` runs for CPU tensors and that the
kernel is held against. ``launches`` counts kernel launches. A bf16
tensor runs the tensor-core (wgmma) kernel, a float32 one the FMA kernel:
a rule by dtype, not a fallback.

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
SYMBOL = "flash_attention_fwd"
# The previous bf16 design (FMA), kept in the library for
# side-by-side timing; only ``previous_design`` calls it.
PREVIOUS_SYMBOL = "flash_attention_fma_fwd"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p]
)


def _fn(symbol: str):
    fn = getattr(_build.load(NAME), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(symbol, q, k, v, causal, window) -> torch.Tensor:
    """Check the arguments and run one call of the C entry point ``symbol``."""
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    err = _fn(symbol)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, kv, d, int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    return out


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
    out = _launch(SYMBOL, q, k, v, causal, window)
    launches += 1
    return out


def previous_design(q, k, v, *, causal=True, window=None) -> torch.Tensor:
    """The previous bf16 design (the FMA kernel) for side-by-side
    timing. Not counted in ``launches``; ``ops`` never calls it."""
    return _launch(PREVIOUS_SYMBOL, q, k, v, causal, window)


__all__ = ["flash_attention", "flash_attention_plain", "launches"]
