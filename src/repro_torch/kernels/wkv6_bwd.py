"""The backward of the RWKV-6 WKV recurrence: the Hopper kernel's wrapper.

The kernel is ``csrc/wkv6_bwd.cu`` (its header says what it replaces,
what bounds it and how). ``wkv6_bwd`` launches it on CUDA tensors and
raises on anything else; ``wkv6_bwd_plain`` (``kernels/ref.py``) is the
same reverse-time recurrences written out in PyTorch, which CPU tensors
take and the kernel is held against. ``launches`` counts kernel calls
(one per call, though a call is two CUDA launches: the walk, then du's
sum over the batch). ``wkv6.WKV6Fn`` calls it; nothing else on a model's
path does.

The kernel recomputes the forward's states from the inputs (a
checkpoint every 16 steps in float32 scratch, 4 x 16 KB a step's worth
of rows kept per block in shared memory), so it needs nothing from the
forward but its inputs, whichever forward design ran.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import wkv6_bwd_plain

NAME = "wkv6_bwd"
MAX_HEAD = 64  # K and V at most
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _fn(symbol: str = "wkv6_bwd"):
    fn = getattr(_build.load(NAME), symbol)
    if fn.argtypes is None:
        if symbol == "wkv6_bwd":
            fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        else:
            fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    return fn


def wkv6_bwd(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K)
    u: torch.Tensor,  # (H, K)
    do: torch.Tensor,  # (B, S, H, V) the gradient of o
    state: Optional[torch.Tensor] = None,  # (B, H, K, V) float32, the initial state
    d_state: Optional[torch.Tensor] = None,  # (B, H, K, V) float32, the last state's gradient
) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv in r's dtype, dw in w's, du in u's, d_state0 float32 or
    None without ``state``) from the CUDA kernel. CUDA tensors only:
    raises otherwise."""
    global launches
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd kernel needs CUDA tensors, got {r.device}")
    if r.dtype not in _DTYPES or w.dtype not in (torch.float32, r.dtype):
        raise TypeError(f"wkv6_bwd takes float32 or bfloat16 r with float32 w or w in r's "
                        f"dtype, got r {r.dtype}, w {w.dtype}")
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"r/v must be (B, S, H, K), got {tuple(r.shape)} / {tuple(v.shape)}")
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if s < 1 or dk > MAX_HEAD or dv > MAX_HEAD:
        raise ValueError(f"wkv6_bwd takes S >= 1 and K, V <= {MAX_HEAD}, got {tuple(r.shape)}, "
                         f"V={dv}")
    dev = r.device
    for name, t, shape, dtype in (
            ("r", r, (b, s, h, dk), r.dtype), ("k", k, (b, s, h, dk), r.dtype),
            ("v", v, (b, s, h, dv), r.dtype), ("w", w, (b, s, h, dk), w.dtype),
            ("u", u, (h, dk), r.dtype), ("do", do, (b, s, h, dv), r.dtype)):
        _check(name, t, shape, dtype, dev)
    for name, t in (("state", state), ("d_state", d_state)):
        if t is not None:
            _check(name, t, (b, h, dk, dv), torch.float32, dev)
    gr, gk, gv, gw = (torch.empty_like(x) for x in (r, k, v, w))
    gu = torch.empty_like(u)
    gs = None if state is None else torch.empty_like(state)
    scratch = torch.empty(_fn("wkv6_bwd_scratch_floats")(b, s, h, dk), dtype=torch.float32,
                          device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _fn()(
        _DTYPES[r.dtype], _DTYPES[w.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), do.data_ptr(), ptr(state), ptr(d_state), gr.data_ptr(),
        gk.data_ptr(), gv.data_ptr(), gw.data_ptr(), gu.data_ptr(), ptr(gs), scratch.data_ptr(),
        b, s, h, dk, dv, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"wkv6_bwd launch failed: cudaError {err}")
    launches += 1
    return gr, gk, gv, gw, gu, gs


__all__ = ["wkv6_bwd", "wkv6_bwd_plain", "launches"]
