"""Flash attention (prefill): the Hopper kernel's wrapper.

The kernel is ``csrc/flash_attention.cu`` (its header says what it
replaces, what bounds it and how). ``flash_attention`` launches it on a
CUDA tensor and raises on anything else; ``flash_attention_plain`` is the
plain PyTorch version that ``ops`` runs for CPU tensors and that the
kernel is held against. ``launches`` counts kernel launches. A bf16
tensor runs the tensor-core (wgmma) kernel, a float32 one the FMA kernel:
a rule by dtype, not a fallback.

Gradients: when autograd is recording and q, k or v requires a gradient,
``flash_attention`` runs ``FlashAttentionFn``: its forward is the same
kernel writing the log-sum-exp as well (float32 (B, H, S)) and saves Q, K,
V, O and LSE; its backward is the hand-written backward kernel
(``flash_attention_bwd.py``, counted there). Otherwise the call writes no
log-sum-exp and saves nothing, so serving is unchanged.

Without positions they are arange (left-aligned prefill); keys at or
past ``S_kv`` do not exist, a causal query attends to keys ``<=`` its
position, a window of ``w`` keeps keys ``> position - w``. Optional int32
``q_pos (B, S)`` and ``kv_pos (B, S_kv)`` make those masks compare
position values (M-RoPE's temporal stream, where an image's tokens share
one position and attend to each other both ways). K and V may have
``S_kv != S`` keys (cross-attention) without a causal mask or window.

Precondition of explicit positions under a causal mask: both are
non-decreasing along S, and ``kv_pos[:, 0] <= q_pos[:, 0]`` (every query
has a key at or before it). The kernel skips a kv tile when its first
key's position exceeds the query tile's last query's position, which is
"every key of the tile is past every query of the tile" only then. The
wrapper does not check it (that would be a host sync on the card); the
plain version does, and the CPU tests hold it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention_bwd as _bwd
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import check_flash_masks
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

NAME = "flash_attention"
SYMBOL = "flash_attention_fwd"
# The previous bf16 design (FMA), kept in the library for
# side-by-side timing; only ``previous_design`` calls it.
PREVIOUS_SYMBOL = "flash_attention_fma_fwd"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p]
)


def _fn(symbol: str):
    fn = getattr(_build.load(NAME), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(symbol, q, k, v, causal, window, q_pos=None, kv_pos=None, with_lse=False):
    """Check the arguments and run one call of the C entry point ``symbol``;
    returns (out, the float32 (B, H, S) log-sum-exp or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention supports float32/bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q/k must be 4-d, got {tuple(q.shape)} / {tuple(k.shape)}")
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d} must be a multiple of 8 up to 256")
    check_flash_masks(s, skv, causal, window, q_pos, kv_pos)
    dev = q.device
    _check("q", q, (b, s, h, d), q.dtype, dev)
    _check("k", k, (b, skv, kv, d), q.dtype, dev)
    _check("v", v, (b, skv, kv, d), q.dtype, dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    # Positions are read only where a mask compares them.
    use_pos = q_pos is not None and (causal or window is not None)
    if use_pos:
        _check("q_pos", q_pos, (b, s), torch.int32, dev)
        _check("kv_pos", kv_pos, (b, skv), torch.int32, dev)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) if with_lse else None
    err = _fn(symbol)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, q_pos.data_ptr() if use_pos else None,
        kv_pos.data_ptr() if use_pos else None,
        b, s, skv, h, kv, d, int(bool(causal)), 0 if window is None else int(window),
        1.0 / math.sqrt(d), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """The kernel with a gradient: forward with the log-sum-exp, backward
    by the backward kernel from the saved Q, K, V, O and LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_pos, kv_pos):
        global launches
        out, lse = _launch(SYMBOL, q, k, v, causal, window, q_pos, kv_pos, with_lse=True)
        launches += 1
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos)
        ctx.mask = (causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        causal, window = ctx.mask
        dq, dk, dv = _bwd.flash_attention_bwd(
            q, k, v, out, do.contiguous(), lse, causal=causal, window=window, q_pos=q_pos,
            kv_pos=kv_pos)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S_kv, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_pos: Optional[torch.Tensor] = None,  # (B, S) int32
    kv_pos: Optional[torch.Tensor] = None,  # (B, S_kv) int32
) -> torch.Tensor:
    """Launch the CUDA kernel. CUDA tensors only: raises otherwise. Through
    ``FlashAttentionFn`` when a gradient is required of q, k or v."""
    global launches
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_pos, kv_pos)
    out, _ = _launch(SYMBOL, q, k, v, causal, window, q_pos, kv_pos)
    launches += 1
    return out


def previous_design(q, k, v, *, causal=True, window=None) -> torch.Tensor:
    """The previous bf16 design (the FMA kernel) for side-by-side
    timing at the shapes it was measured at (S_kv = S, arange positions;
    it raises on the others). Not counted in ``launches``; ``ops`` never
    calls it."""
    if k.shape[1] != q.shape[1]:
        raise ValueError("previous_design takes S_kv == S only")
    return _launch(PREVIOUS_SYMBOL, q, k, v, causal, window)[0]


def flash_attention_lse(q, k, v, *, causal=True, window=None, q_pos=None, kv_pos=None):
    """(out, log-sum-exp) from one kernel call, as ``FlashAttentionFn``'s
    forward makes them; for holding the log-sum-exp against its plain
    version. Not counted in ``launches``; ``ops`` never calls it."""
    return _launch(SYMBOL, q, k, v, causal, window, q_pos, kv_pos, with_lse=True)


__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_plain", "launches"]
