"""Mamba-2 state-space duality (SSD), chunked prefill: the Hopper kernel's
wrapper.

The kernels are in ``csrc/ssd_chunk.cu`` (its header says what they
replace, what bounds them and how). ``ssd_chunk`` launches them on CUDA
tensors and raises on anything else; ``ref.ssd_chunk_plain`` is the plain
PyTorch twin of their arithmetic that ``ops`` runs for CPU tensors, and
``ref.ssd_ref`` (after ``ref.ssd_conv``) the step-by-step recurrence both
are held against.

From the input projection's xBC columns on: the causal depthwise conv of
width 4 (``conv_w`` (4, H P + 2 N), ``conv_b``) and SiLU give x (H heads
of P), B and C (N each, one group); then per batch row and head, from a
zero P x N float32 state, ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t (x) B_t``,
``y_t = S_t C_t + D x_t``, with ``dt = softplus(dt_raw + dt_bias)`` and
``A = -exp(a_log)``. xbc (B, S, H P + 2 N), dt (B, S, H), the conv's and
the per-head parameters share one dtype (float32 or bfloat16); xbc and
dt may be strided along their batch and token dims (views of the input
projection), their last dim contiguous. P <= 64, N a multiple of 4 up to
128. Returns y (B, S, H, P) in xbc's dtype and, when ``last_state``, the
final state (B, H, P, N) in float32. ``launches`` counts calls (four CUDA
launches each). There is no backward kernel: a gradient through it on
the card raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import SSD_CHUNK, ssd_chunk_plain

NAME = "ssd_chunk"
SYMBOL = "ssd_chunk_fwd"
CHUNK = SSD_CHUNK  # kL in the source
MAX_P, MAX_N = 64, 128
CONV_WIDTH = 4  # kW in the source
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 4
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _fn():
    fn = getattr(_build.load(NAME), SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _rows(name: str, t: torch.Tensor, shape, dtype, dev) -> Tuple[int, int]:
    """Check a (B, S, X) operand whose last dim is contiguous; returns its
    (batch, token) strides in elements."""
    if t.device != dev:
        raise ValueError(f"ssd_chunk: {name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"ssd_chunk: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd_chunk: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"ssd_chunk: {name}'s last dim must be contiguous")
    return t.stride(0), t.stride(1)


def ssd_chunk(
    xbc: torch.Tensor,  # (B, S, H P + 2 N) before the conv
    conv_w: torch.Tensor,  # (4, H P + 2 N)
    conv_b: torch.Tensor,  # (H P + 2 N,)
    dt: torch.Tensor,  # (B, S, H)
    dt_bias: torch.Tensor,  # (H,)
    a_log: torch.Tensor,  # (H,)
    d: torch.Tensor,  # (H,)
    *,
    state_size: int,
    last_state: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernels (CUDA tensors only; raises otherwise)."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xbc, conv_w, conv_b, dt, dt_bias, a_log, d)):
        raise RuntimeError("ssd_chunk has no backward kernel; run it under torch.no_grad(), "
                           "or on CPU tensors")
    dev = xbc.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk kernel needs CUDA tensors, got {dev}")
    if xbc.dtype not in _DTYPES:
        raise TypeError(f"ssd_chunk takes float32 or bfloat16, got {xbc.dtype}")
    if xbc.dim() != 3 or dt.dim() != 3:
        raise ValueError(f"xbc must be (B, S, H P + 2 N) and dt (B, S, H), got "
                         f"{tuple(xbc.shape)} / {tuple(dt.shape)}")
    bsz, s, cc = xbc.shape
    h, n = dt.shape[2], state_size
    p = (cc - 2 * n) // h if h else 0
    if (s < 1 or h < 1 or p < 1 or h * p + 2 * n != cc or p > MAX_P or n > MAX_N or n % 4):
        raise ValueError(f"ssd_chunk takes S >= 1, H P + 2 N channels, P <= {MAX_P} and N a "
                         f"multiple of 4 up to {MAX_N}; got xbc {tuple(xbc.shape)}, H={h}, N={n}")
    xb, xs = _rows("xbc", xbc, (bsz, s, cc), xbc.dtype, dev)
    db, ds = _rows("dt", dt, (bsz, s, h), xbc.dtype, dev)
    for name, t, shape in (("conv_w", conv_w, (CONV_WIDTH, cc)), ("conv_b", conv_b, (cc,)),
                           ("dt_bias", dt_bias, (h,)), ("a_log", a_log, (h,)), ("d", d, (h,))):
        if (t.device != dev or t.dtype != xbc.dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"ssd_chunk: {name} must be a contiguous {shape} {xbc.dtype} "
                             f"on {dev}")
    chunks = -(-s // CHUNK)
    y = torch.empty((bsz, s, h, p), dtype=xbc.dtype, device=dev)
    last = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev) if last_state else None
    # Scratch: each chunk's state contribution, then the state entering it
    # (B, H, C, P, N); each chunk's C B^T (B, C, 64, 64); each chunk's decay
    # (B, H, C).
    n_slots, n_cb = bsz * h * chunks * p * n, bsz * chunks * CHUNK * CHUNK
    scratch = torch.empty(n_slots + n_cb + bsz * h * chunks, dtype=torch.float32, device=dev)
    slots = scratch.data_ptr()
    err = _fn()(_DTYPES[xbc.dtype], xbc.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
                dt.data_ptr(), dt_bias.data_ptr(), a_log.data_ptr(), d.data_ptr(), y.data_ptr(),
                None if last is None else last.data_ptr(), slots, slots + 4 * (n_slots + n_cb),
                slots + 4 * n_slots, xb, xs, db, ds, bsz, s, h, p, n,
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{SYMBOL} launch failed: cudaError {err}")
    launches += 1
    return y, last


__all__ = ["ssd_chunk", "ssd_chunk_plain", "launches", "CHUNK"]
