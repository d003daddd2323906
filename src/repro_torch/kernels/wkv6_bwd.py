"""The backward of the RWKV-6 WKV recurrence: the Hopper kernel's wrapper.

The kernel is ``csrc/wkv6_bwd.cu`` (its header says what it replaces,
what bounds it and how). ``wkv6_bwd`` launches it on CUDA tensors and
raises on anything else; ``wkv6_bwd_plain`` (``kernels/ref.py``) is the
same reverse-time recurrences written out in PyTorch, which CPU tensors
take and the kernel is held against (``ref.wkv6_bwd_chunked_plain``
repeats the chunked design's arithmetic). ``launches`` counts kernel
calls (one per call, though a call is several CUDA launches: seven in
the chunked design, two in the sequential one). ``wkv6.WKV6Fn`` calls
it; nothing else on a model's path does.

Two designs, a rule by dtype (never a fallback): bfloat16 r runs the
chunked design (64-step chunks in parallel: the states entering and the
gradients leaving each chunk from the chunked forward's tensor-core
summaries and carries, run forwards and with time reversed; dv from its
output kernel; one block per chunk for dr, dk, dw from 16-step
sub-chunks; du's partials summed in order); float32 r, whose 2e-5
tolerance bf16 products cannot meet, runs the sequential design (one
block per (b, h) over all of time).
``previous_design`` runs the sequential design at every dtype, for
side-by-side timing only. Both recompute the forward's states from the
inputs, so they need nothing from the forward but its inputs, whichever
forward design ran.
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
        if symbol == "wkv6_bwd_scratch_floats":
            fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_longlong
        else:
            fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def design(r_dtype: torch.dtype) -> str:
    """The design a call with r in this dtype runs: "chunked" for
    bfloat16, "sequential" for float32."""
    return "chunked" if r_dtype == torch.bfloat16 else "sequential"


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
    out = _launch("wkv6_bwd", r, k, v, w, u, do, state, d_state)
    launches += 1
    return out


def previous_design(r, k, v, w, u, do, state=None, d_state=None):
    """The sequential design at every dtype on the same arguments, for
    side-by-side timing. Not counted in ``launches``; nothing on a model's
    path calls it."""
    return _launch("wkv6_bwd_previous", r, k, v, w, u, do, state, d_state)


def _launch(symbol, r, k, v, w, u, do, state, d_state):
    """Check the arguments and run one call of the C entry point ``symbol``."""
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
    chunked = symbol == "wkv6_bwd" and design(r.dtype) == "chunked"
    scratch = torch.empty(_fn("wkv6_bwd_scratch_floats")(int(chunked), b, s, h, dk, dv),
                          dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _fn(symbol)(
        _DTYPES[r.dtype], _DTYPES[w.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), do.data_ptr(), ptr(state), ptr(d_state), gr.data_ptr(),
        gk.data_ptr(), gv.data_ptr(), gw.data_ptr(), gu.data_ptr(), ptr(gs), scratch.data_ptr(),
        b, s, h, dk, dv, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    return gr, gk, gv, gw, gu, gs


__all__ = ["design", "wkv6_bwd", "wkv6_bwd_plain", "launches", "previous_design"]
