"""Mamba-2 decode step over the arena's rows: the Hopper kernel's wrapper.

The kernels are in ``csrc/ssd_step.cu`` (its header says what they
replace, what bounds them and how). ``ssd_step`` launches them on CUDA
tensors and raises on anything else; ``ref.ssd_step_plain`` is the plain
PyTorch version that ``ops`` runs for CPU tensors and that the kernel is
held against.

One token per row: the causal conv over the row's carried window
(``conv_state``, the last W - 1 = 3 inputs, float32) and this token's
inputs ``xbc`` (B, H P + 2 N), SiLU, then one state step of each head's
P x N float32 ``state`` (``ref.ssd_ref``'s). Both states are updated IN
PLACE on the rows ``active`` marks (every row when None); a held row is
left untouched and outputs 0. xbc and dt (B, H) may be row-strided views
of the input projection. Returns y (B, H P) in xbc's dtype. One group
of B and C, P <= 64, N a power of two from 4 to 128. ``launches`` counts
calls (two CUDA launches each).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_step_plain

NAME = "ssd_step"
SYMBOL = "ssd_step_fwd"
CONV_WIDTH = 4  # kW in the source
MAX_P, MAX_N = 64, 128
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_longlong] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


def _fn():
    fn = getattr(_build.load(NAME), SYMBOL)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, dev, contiguous=True):
    if t.device != dev:
        raise ValueError(f"ssd_step: {name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"ssd_step: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd_step: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"ssd_step: {name} must be contiguous")
    if not contiguous and t.stride(-1) != 1:
        raise ValueError(f"ssd_step: {name}'s rows must be contiguous")


def ssd_step(
    xbc: torch.Tensor,  # (B, H P + 2 N)
    dt: torch.Tensor,  # (B, H)
    conv_state: torch.Tensor,  # (B, 3, H P + 2 N) float32, in place
    conv_w: torch.Tensor,  # (4, H P + 2 N)
    conv_b: torch.Tensor,  # (H P + 2 N,)
    dt_bias: torch.Tensor,  # (H,)
    a_log: torch.Tensor,  # (H,)
    d: torch.Tensor,  # (H,)
    state: torch.Tensor,  # (B, H, P, N) float32, in place
    active: Optional[torch.Tensor] = None,  # (B,) bool
) -> torch.Tensor:
    """Launch the kernels (CUDA tensors only; raises otherwise)."""
    global launches
    dev = xbc.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_step kernel needs CUDA tensors, got {dev}")
    if xbc.dtype not in _DTYPES:
        raise TypeError(f"ssd_step takes float32 or bfloat16, got {xbc.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xbc, dt, conv_w, conv_b,
                                                                 dt_bias, a_log, d)):
        raise RuntimeError("ssd_step has no backward kernel: training never decodes")
    bsz, cc = xbc.shape
    h, p, n = state.shape[1:]
    if p > MAX_P or n < 4 or n > MAX_N or n & (n - 1) or cc != h * p + 2 * n:
        raise ValueError(f"ssd_step takes one group, P <= {MAX_P}, N a power of two from 4 to "
                         f"{MAX_N} and H P + 2 N channels; got state "
                         f"{tuple(state.shape)}, xbc {tuple(xbc.shape)}")
    dtype = xbc.dtype
    _check("xbc", xbc, (bsz, cc), dtype, dev, contiguous=False)
    _check("dt", dt, (bsz, h), dtype, dev, contiguous=False)
    _check("conv_state", conv_state, (bsz, CONV_WIDTH - 1, cc), torch.float32, dev)
    _check("conv_w", conv_w, (CONV_WIDTH, cc), dtype, dev)
    _check("conv_b", conv_b, (cc,), dtype, dev)
    for name, t in (("dt_bias", dt_bias), ("a_log", a_log), ("d", d)):
        _check(name, t, (h,), dtype, dev)
    _check("state", state, (bsz, h, p, n), torch.float32, dev)
    if state.data_ptr() % 16:
        raise ValueError("ssd_step: state must be 16-byte aligned")
    if active is not None:
        _check("active", active, (bsz,), torch.bool, dev)
    u = torch.empty((bsz, cc), dtype=torch.float32, device=dev)
    y = torch.empty((bsz, h * p), dtype=dtype, device=dev)
    err = _fn()(_DTYPES[dtype], xbc.data_ptr(), xbc.stride(0), dt.data_ptr(), dt.stride(0),
                conv_state.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
                a_log.data_ptr(), d.data_ptr(), state.data_ptr(),
                None if active is None else active.data_ptr(), u.data_ptr(), y.data_ptr(),
                bsz, h, p, n, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{SYMBOL} launch failed: cudaError {err}")
    launches += 1
    return y


__all__ = ["ssd_step", "ssd_step_plain", "launches"]
