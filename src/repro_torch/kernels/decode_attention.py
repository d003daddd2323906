"""Decode (single-token) attention: the Hopper kernel's wrapper.

The kernel is ``csrc/decode_attention.cu`` (its header says what it
replaces, what bounds it and how). ``decode_attention`` launches it on a
CUDA tensor and raises on anything else; ``decode_attention_plain`` is
the plain PyTorch version that ``ops`` runs for CPU tensors and that the
kernel is held against. ``launches`` counts calls that launched the
kernel: one per call, though a call is two CUDA launches (the split
partials, then their combine).

Semantics (shared with the plain version): slot ``s`` of row ``b`` is
live when ``kv_pos <= cursor & kv_valid & active`` (and
``kv_pos > cursor - window`` under a window); ``causal=False``
(cross-attention against an encoder's K/V) drops the ``kv_pos <= cursor``
term. A row with no live slot outputs exact 0.

S is split over blocks by ``plan_splits``; ``ref.decode_attention_split_plain``
is the plain twin of that two-pass arithmetic.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref as decode_attention_plain

NAME = "decode_attention"
SYMBOL = "decode_attention_fwd"
# The previous bf16 design (FMA, no split), kept in the library for
# side-by-side timing; only ``previous_design`` calls it.
PREVIOUS_SYMBOL = "decode_attention_fma_fwd"
TILE = 64  # slots per kernel tile
BLOCKS_PER_SM = 4
MAX_SPLIT = 256  # the combine kernel's limit
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def plan_splits(b: int, kv: int, s: int, sm_count: int) -> Tuple[int, int]:
    """``(n_split, tiles_per_split)`` for a call over ``s`` slots: about
    ``BLOCKS_PER_SM`` blocks per SM over the ``b * kv`` (row, kv head)
    pairs, at least two 64-slot tiles a split, every split non-empty.
    A pure function: one shape on one card always gets one plan, so a
    step is deterministic."""
    tiles = -(-s // TILE)
    want = -(-BLOCKS_PER_SM * sm_count // (b * kv))
    n = max(1, min(want, tiles // 2, MAX_SPLIT))
    per = -(-tiles // n)
    return -(-tiles // per), per


def _sm_count(dev: torch.device) -> int:
    return _sm_count_of(dev.index if dev.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)  # one entry per card
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn(symbol: str):
    fn = getattr(_build.load(NAME), symbol)
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


def _launch(symbol, q, cache_k, cache_v, cursor, kv_pos, kv_valid, active, window,
            causal=True, n_split: Optional[int] = None) -> torch.Tensor:
    """Check the arguments, plan the split (or take ``n_split``) and run
    one call of the C entry point ``symbol``."""
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
    if n_split is None:
        n_split, per = plan_splits(b, kv, s, _sm_count(dev))
    else:
        tiles = -(-s // TILE)
        per = -(-tiles // n_split)
    out = torch.empty_like(q)
    # The split partials, float32: m and l per (split, row, head), then acc.
    n = n_split * b * h
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=dev)
    ptr = part.data_ptr()
    err = _fn(symbol)(
        _DTYPES[q.dtype], q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        cursor.data_ptr(), kv_pos.data_ptr(), kv_valid.data_ptr(),
        None if active is None else active.data_ptr(), out.data_ptr(),
        ptr, ptr + 4 * n, ptr + 8 * n,
        b, s, kv, h // kv, d, int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), n_split, per, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    return out


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
    causal: bool = True,
) -> torch.Tensor:
    """Launch the CUDA kernel. CUDA tensors only: raises otherwise."""
    global launches
    out = _launch(SYMBOL, q, cache_k, cache_v, cursor, kv_pos, kv_valid, active, window,
                  causal)
    launches += 1
    return out


def previous_design(q, cache_k, cache_v, cursor, kv_pos, kv_valid, active=None, *,
                    window=None, causal=True) -> torch.Tensor:
    """The previous bf16 design (FMA, one split: a grid of one block per
    (row, kv head)) for side-by-side timing. Not counted in
    ``launches``; ``ops`` never calls it."""
    return _launch(PREVIOUS_SYMBOL, q, cache_k, cache_v, cursor, kv_pos, kv_valid, active,
                   window, causal, n_split=1)


__all__ = ["decode_attention", "decode_attention_plain", "launches", "plan_splits"]
