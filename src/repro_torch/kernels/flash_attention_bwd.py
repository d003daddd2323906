"""The backward of flash attention: the Hopper kernel's wrapper.

The kernel is ``csrc/flash_attention_bwd.cu`` (its header says what it
replaces, what bounds it and how). ``flash_attention_bwd`` launches it on
CUDA tensors and raises on anything else; ``flash_attention_bwd_plain``
(``kernels/ref.py``) is the same recurrences written out in PyTorch, which
CPU tensors take and the kernel is held against. ``launches`` counts
kernel calls (one per call, though a call is three CUDA launches: Delta,
dK/dV, dQ). ``flash_attention.FlashAttentionFn`` calls it; nothing else on
a model's path does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import check_flash_masks, flash_attention_bwd_plain

NAME = "flash_attention_bwd"
SYMBOL = "flash_attention_bwd"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p]
)


def _fn():
    fn = getattr(_build.load(NAME), SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S_kv, KV, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, S, H, D) the forward's output
    do: torch.Tensor,  # (B, S, H, D)
    lse: torch.Tensor,  # (B, H, S) float32, the forward's log-sum-exp
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_pos: Optional[torch.Tensor] = None,  # (B, S) int32
    kv_pos: Optional[torch.Tensor] = None,  # (B, S_kv) int32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) in the inputs' dtype from the CUDA kernel. CUDA tensors
    only: raises otherwise. Masks and positions as in the forward."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_bwd supports float32/bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q/k must be 4-d, got {tuple(q.shape)} / {tuple(k.shape)}")
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    if d % 8 or d > 256 or (q.dtype == torch.float32 and d > 128):
        raise ValueError(f"head dim {d} must be a multiple of 8 up to 256 (128 in float32)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    check_flash_masks(s, skv, causal, window, q_pos, kv_pos)
    dev = q.device
    for name, t, shape in (("q", q, (b, s, h, d)), ("k", k, (b, skv, kv, d)),
                           ("v", v, (b, skv, kv, d)), ("o", o, (b, s, h, d)),
                           ("do", do, (b, s, h, d))):
        _check(name, t, shape, q.dtype, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _check("lse", lse, (b, h, s), torch.float32, dev)
    use_pos = q_pos is not None and (causal or window is not None)
    if use_pos:
        _check("q_pos", q_pos, (b, s), torch.int32, dev)
        _check("kv_pos", kv_pos, (b, skv), torch.int32, dev)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _fn()(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), q_pos.data_ptr() if use_pos else None,
        kv_pos.data_ptr() if use_pos else None,
        b, s, skv, h, kv, d, int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{SYMBOL} launch failed: cudaError {err}")
    launches += 1
    return dq, dk, dv


__all__ = ["flash_attention_bwd", "flash_attention_bwd_plain", "launches"]
