"""The backward of flash attention: the Hopper kernel's wrapper.

The kernel is ``csrc/flash_attention_bwd.cu`` (its header says what it
replaces, what bounds it and how). ``flash_attention_bwd`` launches it on
CUDA tensors and raises on anything else; ``flash_attention_bwd_plain``
(``kernels/ref.py``) is the same recurrences written out in PyTorch, which
CPU tensors take and the kernel is held against. ``launches`` counts
kernel calls (one per call, though a call is three CUDA launches: Delta,
dK/dV, dQ). ``flash_attention.FlashAttentionFn`` calls it; nothing else on
a model's path does.

Routes, a rule by dtype and head dim (``route``), never a fallback:
bfloat16 with D <= 128 runs the wgmma kernels; bfloat16 with 128 < D <=
256 the wide wgmma kernels (two warpgroups a block, each on half of D;
the dK/dV sum over each group's query heads split into
``ref.flash_bwd_head_parts`` parts when the keys alone give too few
blocks for the card, the float32 partials summed in order by a fourth
launch); float32 (D <= 128) the first design's FMA kernels.
``previous_design`` runs the first design (``mma.sync``) at every
bfloat16 D, for side-by-side timing only.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import (check_flash_masks, flash_attention_bwd_plain,
                                     flash_bwd_head_parts)

NAME = "flash_attention_bwd"
SYMBOL = "flash_attention_bwd"
# The first design (mma.sync for bf16), kept in the library for
# side-by-side timing; only ``previous_design`` calls it.
PREVIOUS_SYMBOL = "flash_attention_bwd_previous"
ROUTE_SYMBOL = "flash_attention_bwd_route"
ROUTES = {0: "fma", 2: "wgmma", 3: "wgmma_wide"}
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
)


def _fn(symbol: str = SYMBOL):
    fn = getattr(_build.load(NAME), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def route(dtype: torch.dtype, d: int) -> str:
    """The kernels a call with this dtype and head dim runs, by the rule
    above: "wgmma", "wgmma_wide" or "fma"; raises for what no route takes
    (head dims are multiples of 8, up to 256 in bfloat16 and 128 in
    float32, the first design's shared memory)."""
    if d % 8 or d < 8 or dtype not in _DTYPES or d > (128 if dtype == torch.float32 else 256):
        raise ValueError(f"no backward route for {dtype} at head dim {d}: head dims are "
                         "multiples of 8 up to 256 (128 in float32)")
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if d <= 128 else "wgmma_wide"


def kernel_route(dtype: torch.dtype, d: int) -> str:
    """The route the built library's dispatch takes for (dtype, D), from
    its own ``route`` (to hold against ``route``); needs the library."""
    lib = _build.load(NAME)
    fn = getattr(lib, ROUTE_SYMBOL)
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    got = fn(_DTYPES.get(dtype, -1), d)
    if got not in ROUTES:
        raise ValueError(f"no backward route for {dtype} at head dim {d}")
    return ROUTES[got]


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
    out = _launch(SYMBOL, q, k, v, o, do, lse, causal, window, q_pos, kv_pos)
    launches += 1
    return out


def previous_design(q, k, v, o, do, lse, *, causal=True, window=None, q_pos=None,
                    kv_pos=None):
    """The first design (``mma.sync`` for bfloat16 at every D, FMA for
    float32) on the same arguments, for side-by-side timing. Not counted
    in ``launches``; nothing on a model's path calls it."""
    return _launch(PREVIOUS_SYMBOL, q, k, v, o, do, lse, causal, window, q_pos, kv_pos)


def head_parts(b: int, skv: int, h: int, kv: int, d: int, dtype: torch.dtype,
               device: torch.device) -> int:
    """How many parts the wide route splits each group's query heads into
    for dK/dV on ``device`` (``ref.flash_bwd_head_parts`` at its SM count);
    1 on every other route."""
    if route(dtype, d) != "wgmma_wide":
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return flash_bwd_head_parts(b, skv, kv, h // kv, sms)


def _launch(symbol, q, k, v, o, do, lse, causal, window, q_pos, kv_pos):
    """Check the arguments and run one call of the C entry point ``symbol``."""
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
    route(q.dtype, d)  # raises for a head dim no route takes
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
    parts = head_parts(b, skv, h, kv, d, q.dtype, dev) if symbol == SYMBOL else 1
    part = (torch.empty(2 * parts * k.numel(), dtype=torch.float32, device=dev) if parts > 1
            else None)
    err = _fn(symbol)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), q_pos.data_ptr() if use_pos else None,
        kv_pos.data_ptr() if use_pos else None,
        b, s, skv, h, kv, d, int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), parts, None if part is None else part.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    return dq, dk, dv


__all__ = ["flash_attention_bwd", "flash_attention_bwd_plain", "head_parts", "launches",
           "previous_design", "route"]
