"""RG-LRU linear recurrence: the Hopper kernel's wrapper.

The kernel is ``csrc/rglru.cu`` (its header says what it replaces, what
bounds it and how). ``rglru_scan`` launches it on CUDA tensors and raises
on anything else; ``rglru_scan_plain`` is the plain PyTorch version that
``ops`` runs for CPU tensors and that the kernel is held against.
``launches`` counts kernel launches.

Gradients: when autograd is recording and a, b or h0 requires a
gradient, ``rglru_scan`` runs ``RGLRUScanFn``: its forward is the same
kernel and saves a, h and h0; its backward is the hand-written backward
kernel (``rglru_bwd.py``, counted there). Otherwise the call saves
nothing, so serving is unchanged.

Channel-wise ``h_t = a_t h_{t-1} + b_t`` from ``h0`` (zeros when absent);
a and b share one dtype (float32 or bfloat16); h comes out in a's dtype,
the last h in float32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rglru_bwd as _bwd
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import rglru_ref as rglru_scan_plain

NAME = "rglru"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib():
    lib = _build.load(NAME)
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(a, b, h0):
    """Check the arguments and run one call of the forward kernel."""
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan kernel needs CUDA tensors, got {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"rglru_scan supports float32/bfloat16, got {a.dtype}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, D), got {tuple(a.shape)}")
    bsz, s, d = a.shape
    if s < 1 or not 1 <= bsz <= 65535:
        raise ValueError(f"rglru_scan takes S >= 1 and 1 <= B <= 65535, got {tuple(a.shape)}")
    dev = a.device
    _check("a", a, (bsz, s, d), a.dtype, dev)
    _check("b", b, (bsz, s, d), a.dtype, dev)
    if h0 is not None:
        _check("h0", h0, (bsz, d), torch.float32, dev)
    out = torch.empty_like(a)
    h_last = torch.empty((bsz, d), dtype=torch.float32, device=dev)
    err = _lib()(
        _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
        None if h0 is None else h0.data_ptr(), out.data_ptr(), h_last.data_ptr(),
        bsz, s, d, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rglru_scan launch failed: cudaError {err}")
    return out, h_last


class RGLRUScanFn(torch.autograd.Function):
    """The kernel with a gradient: forward saving a, h and h0, backward by
    the backward kernel (h_{t-1} read from the saved h)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        global launches
        out, h_last = _launch(a, b, h0)
        launches += 1
        ctx.save_for_backward(a, out, h0)
        ctx.set_materialize_grads(False)
        return out, h_last

    @staticmethod
    def backward(ctx, dout, dh_last):
        a, out, h0 = ctx.saved_tensors
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        da, db, dh0 = _bwd.rglru_bwd(a, out, dout,
                                     None if dh_last is None else dh_last.contiguous(), h0)
        return da, db, None if h0 is None else dh0


def rglru_scan(
    a: torch.Tensor,  # (B, S, D) decay in (0, 1)
    b: torch.Tensor,  # (B, S, D) inputs
    h0: Optional[torch.Tensor] = None,  # (B, D) float32; None = zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. CUDA tensors only: raises otherwise. Through
    ``RGLRUScanFn`` when a gradient is required of a, b or h0."""
    global launches
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (a, b, h0)):
        return RGLRUScanFn.apply(a, b, h0)
    out = _launch(a, b, h0)
    launches += 1
    return out


__all__ = ["RGLRUScanFn", "rglru_scan", "rglru_scan_plain", "launches"]
