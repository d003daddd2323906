"""Row normalisation (RMSNorm, LayerNorm): the Hopper kernel's wrapper.

The kernel is ``csrc/rownorm.cu`` (its header says what it replaces,
what bounds it and how). ``rownorm`` launches it on CUDA tensors and
raises on anything else; ``rownorm_plain`` is the plain PyTorch version
(``ref.rmsnorm_ref`` and ``ref.layernorm_ref``, the eager float32
chains) that ``ops`` runs for CPU tensors and that the kernel is held
against.
``launches`` counts calls that launched the kernel.

Each row of the last dim d is normalised with float32 statistics:
``center=False`` is RMS, ``y = (x * rsqrt(mean(x^2) + eps)) * (1 + w)``;
``center=True`` is layer norm, ``y = ((x - mu) * rsqrt(var + eps)) * w +
b`` with the biased variance. x is float32 or bfloat16 and y comes out
in x's dtype; w and b are float32 or bfloat16 (one dtype). d is a
multiple of 8 up to ``MAX_D``. The leading dims may be strided as long
as they flatten to rows of one stride (a batch's last position); y is
contiguous. A ``gate`` (RMS only; x's shape and dtype, rows of one
stride) makes it Mamba-2's gated norm: the row normalised is
``x * silu(gate)``, taken in float32 in the same pass
(``rownorm_gated_fwd``); without one the launch is the ungated kernel's.

Gradients: when autograd is recording and x, w or b requires a
gradient, ``rownorm`` runs ``RownormFn``: its forward is the same kernel
launch and saves the inputs; its backward recomputes the plain chain
from them and returns autograd's gradient of it, the gradient the model
had before the kernel (there is no backward kernel). Otherwise the call
saves nothing, so serving is unchanged.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rownorm_plain

NAME = "rownorm"
SYMBOL = "rownorm_fwd"
GATED_SYMBOL = "rownorm_gated_fwd"
MAX_D = 16384  # the zoo's widest model (kMaxD in the source)
MAX_THREADS = 256  # kMaxThreads in the source
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = {
    SYMBOL: ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    GATED_SYMBOL: ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}


def _fn(symbol: str = SYMBOL):
    fn = getattr(_build.load(NAME), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def plan(d: int, element_size: int) -> Tuple[int, int]:
    """``(threads, vectors a thread)`` of the block that normalises one
    row of ``d`` elements of ``element_size`` bytes: two 16-byte vectors
    a thread, in whole warps, at most ``MAX_THREADS`` threads. A pure
    function, so one d always takes one plan and its sums one order."""
    nvec = d * element_size // 16
    threads = min(MAX_THREADS, max(32, -(-nvec // 64) * 32))
    return threads, -(-nvec // threads)


def check_shapes(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 center: bool, gate: Optional[torch.Tensor] = None) -> None:
    """Raise for what the kernel does not take: a dtype, a width or a
    weight shape. Reads shapes and dtypes only, on any device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"rownorm supports float32/bfloat16 inputs, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("rownorm needs at least one dim")
    d = x.shape[-1]
    if d < 8 or d % 8 or d > MAX_D:
        raise ValueError(f"rownorm takes a last dim that is a multiple of 8 up to {MAX_D}, "
                         f"got {d}")
    if center != (b is not None):
        raise ValueError("layer norm (center=True) takes a bias, RMS norm none")
    if gate is not None and (center or gate.dtype != x.dtype or gate.shape != x.shape):
        raise ValueError(f"rownorm's gate is for RMS norm, in x's shape and dtype; got "
                         f"{gate.dtype} {tuple(gate.shape)} beside {x.dtype} {tuple(x.shape)}")
    for name, t in (("w", w), ("b", b)):
        if t is None:
            continue
        if t.dtype not in _DTYPES or t.dtype != w.dtype:
            raise TypeError(f"rownorm's {name} must be float32/bfloat16 like w, got {t.dtype}")
        if tuple(t.shape) != (d,):
            raise ValueError(f"rownorm's {name} has shape {tuple(t.shape)}, expected ({d},)")


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def rownorm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
            eps: float, center: bool, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel (through ``RownormFn`` when a gradient is
    required; the gated form has none and raises then). CUDA tensors
    only: raises otherwise."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w, b, gate)):
        if gate is not None:
            raise RuntimeError("rownorm's gated form has no backward on the card")
        return RownormFn.apply(x, w, b, eps, center)
    return _forward(x, w, b, eps=eps, center=center, gate=gate)


class RownormFn(torch.autograd.Function):
    """The kernel's forward; the backward is autograd's through the plain
    chain, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, b, eps, center):
        ctx.eps, ctx.center = eps, center
        ctx.save_for_backward(x, w, b)
        return _forward(x, w, b, eps=eps, center=center)

    @staticmethod
    def backward(ctx, gy):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y = rownorm_plain(*ins, eps=ctx.eps, center=ctx.center)
            grads = iter(torch.autograd.grad(y, [t for t, n in zip(ins, need) if n], gy))
        return (*(next(grads) if n else None for n in need), None, None)


def _rows(t: torch.Tensor, d: int) -> torch.Tensor:
    """t's rows as a 2-D view of one stride the kernel reads, else a copy."""
    rows2 = t.reshape(-1, d)  # a view wherever the rows share one stride
    if (rows2.stride(1) != 1 or rows2.stride(0) % 8 or rows2.stride(0) < d
            or not _aligned(rows2)):
        rows2 = rows2.contiguous()
    return rows2


def _forward(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *, eps: float,
             center: bool, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the kernel; saves nothing."""
    global launches
    check_shapes(x, w, b, center, gate)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rownorm kernel needs CUDA tensors, got {dev}")
    for name, t in (("w", w), ("b", b), ("gate", gate)):
        if t is not None and t.device != dev:
            raise ValueError(f"rownorm's {name} is on {t.device}, expected {dev}")
    d = x.shape[-1]
    rows2 = _rows(x, d)
    w, b = w.contiguous(), None if b is None else b.contiguous()
    if not all(_aligned(t) for t in (w, b) if t is not None):
        raise ValueError("rownorm's weights must be 16-byte aligned")
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    rows = rows2.shape[0]
    if rows == 0:
        return y
    if rows >= 2**31:
        raise ValueError(f"rownorm takes fewer than 2**31 rows, got {rows}")
    threads, _ = plan(d, x.element_size())
    if gate is not None:
        g2 = _rows(gate, d)
        err = _fn(GATED_SYMBOL)(_DTYPES[x.dtype], _DTYPES[w.dtype], rows2.data_ptr(),
                                g2.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
                                rows2.stride(0), g2.stride(0), float(eps), threads,
                                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{GATED_SYMBOL} launch failed: cudaError {err}")
        launches += 1
        return y
    err = _fn()(_DTYPES[x.dtype], _DTYPES[w.dtype], int(center), rows2.data_ptr(),
                w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(), rows, d,
                rows2.stride(0), float(eps), threads,
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{SYMBOL} launch failed: cudaError {err}")
    launches += 1
    return y


__all__ = ["rownorm", "RownormFn", "rownorm_plain", "launches", "plan", "check_shapes", "MAX_D"]
