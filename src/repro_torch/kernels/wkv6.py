"""RWKV-6 WKV recurrence: the Hopper kernel's wrapper.

The kernel is ``csrc/wkv6.cu`` (its header says what it replaces, what
bounds it and how). ``wkv6`` launches it on CUDA tensors and raises on
anything else; ``wkv6_plain`` is the plain PyTorch version that ``ops``
runs for CPU tensors and that the kernel is held against. ``launches``
counts kernel launches.

Per (batch, head), with a K x V float32 state S:
``o_t = r_t (S + diag(u) k_tᵀ v_t)``, then ``S <- diag(w_t) S + k_tᵀ v_t``.
r, k, v and u share one dtype (float32 or bfloat16); w is float32 (as the
model makes it) or that dtype (as the reference's bfloat16 sweep passes
it); o comes out in r's dtype, the state in float32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import wkv6_ref

NAME = "wkv6"
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD = 64  # K and V at most (the state column lives in registers)
_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib():
    lib = _build.load(NAME)
    fn = lib.wkv6_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def wkv6_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    *,
    state_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``wkv6`` (``ref.wkv6_ref``), any device. The
    last state is copied into ``state_out`` when given."""
    out, last = wkv6_ref(r, k, v, w, u, state)
    if state_out is not None:
        last = state_out.copy_(last)
    return out, last


def wkv6(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K)
    u: torch.Tensor,  # (H, K)
    state: Optional[torch.Tensor] = None,  # (B, H, K, V) float32; None = zeros
    *,
    state_out: Optional[torch.Tensor] = None,  # (B, H, K, V) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. CUDA tensors only: raises otherwise.
    Returns (o, last state). The last state goes to ``state_out`` when
    given, which may be ``state`` itself: the serving engine's arena is
    then updated in place."""
    global launches
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 kernel needs CUDA tensors, got {r.device}")
    if r.dtype not in _DTYPES or w.dtype not in (torch.float32, r.dtype):
        raise TypeError(
            f"wkv6 takes float32 or bfloat16 r with float32 w or w in r's dtype, "
            f"got r {r.dtype}, w {w.dtype}"
        )
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"r/v must be (B, S, H, K), got {tuple(r.shape)} / {tuple(v.shape)}")
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if s < 1 or dk > MAX_HEAD or dv > MAX_HEAD:
        raise ValueError(f"wkv6 takes S >= 1 and K, V <= {MAX_HEAD}, got {tuple(r.shape)}, V={dv}")
    dev = r.device
    _check("r", r, (b, s, h, dk), r.dtype, dev)
    _check("k", k, (b, s, h, dk), r.dtype, dev)
    _check("v", v, (b, s, h, dv), r.dtype, dev)
    _check("w", w, (b, s, h, dk), w.dtype, dev)
    _check("u", u, (h, dk), r.dtype, dev)
    if state is not None:
        _check("state", state, (b, h, dk, dv), torch.float32, dev)
    if state_out is None:
        state_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    else:
        _check("state_out", state_out, (b, h, dk, dv), torch.float32, dev)
    out = torch.empty((b, s, h, dv), dtype=r.dtype, device=dev)
    err = _lib()(
        _DTYPES[r.dtype], _DTYPES[w.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), None if state is None else state.data_ptr(),
        out.data_ptr(), state_out.data_ptr(), b, s, h, dk, dv,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"wkv6 launch failed: cudaError {err}")
    launches += 1
    return out, state_out


__all__ = ["wkv6", "wkv6_plain", "launches"]
