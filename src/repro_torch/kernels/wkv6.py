"""RWKV-6 WKV recurrence: the Hopper kernels' wrapper.

The kernels are in ``csrc/wkv6.cu`` (its header says what they replace,
what bounds them and how). ``wkv6`` launches them on CUDA tensors and
raises on anything else; ``wkv6_plain`` is the plain PyTorch version that
``ops`` runs for CPU tensors and that the kernels are held against.

Per (batch, head), with a K x V float32 state S:
``o_t = r_t (S + diag(u) k_tᵀ v_t)``, then ``S <- diag(w_t) S + k_tᵀ v_t``.
r, k, v and u share one dtype (float32 or bfloat16); w is float32 (as the
model makes it) or that dtype (as the reference's bfloat16 sweep passes
it); o comes out in r's dtype, the state in float32.

Two designs, chosen by ``uses_chunked(dtype, S)`` alone, so one shape
always takes one path and two calls agree bit for bit:

- **chunked** (bfloat16 r and S >= ``CHUNK``): 64-step chunks in
  parallel, their products on the tensor cores with each decayed operand
  split into two bf16 parts, the state carried between chunks in float32;
  three CUDA launches in a fixed order. ``ref.wkv6_chunked_plain`` is the
  plain twin of its arithmetic.
- **sequential** (float32 r, whose 2e-5 tolerance bf16 products cannot
  meet, or S < ``CHUNK``, as decode's S = 1): one block per (batch, head)
  stepping through time with the state in registers.

``launches`` counts calls that launched a kernel: one per call, though a
chunked call is three CUDA launches. ``previous_design`` runs the
sequential kernel on any shape, for side-by-side timing only.

Gradients: when autograd is recording and any of r, k, v, w, u or the
initial state requires a gradient, ``wkv6`` runs ``WKV6Fn``: its forward
is the same kernel (the design ``uses_chunked`` picks) and saves its
inputs; its backward is the hand-written backward kernel
(``wkv6_bwd.py``, counted there), which recomputes the states from them.
``state_out`` (the decode arena, written in place) is refused there.
Otherwise the call saves nothing, so serving is unchanged.

``active`` (B,) bool, for decode over the arena: a row whose flag is off
is not stepped: its output is 0 and its state stays as it came in
(``state_out`` takes it), in the sequential kernel's own launch. Only
the sequential design takes it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import wkv6_bwd as _bwd
from repro_torch.kernels.decode_attention import _check
from repro_torch.kernels.ref import wkv6_ref

NAME = "wkv6"
CHUNK = 64  # steps per chunk of the chunked design (kT in the source)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD = 64  # K and V at most (the state column lives in registers)
_ARGTYPES = {
    "wkv6_fwd": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "wkv6_chunked_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def _fn(symbol: str):
    fn = getattr(_build.load(NAME), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def uses_chunked(dtype: torch.dtype, s: int) -> bool:
    """Whether a call with r of ``dtype`` over ``s`` steps takes the
    chunked kernel (else the sequential one)."""
    return dtype == torch.bfloat16 and s >= CHUNK


def wkv6_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    *,
    state_out: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``wkv6`` (``ref.wkv6_ref``), any device. The
    last state is copied into ``state_out`` when given. Rows ``active``
    marks off keep their state and output 0."""
    out, last = wkv6_ref(r, k, v, w, u, state)
    if active is not None:
        keep = torch.zeros_like(last) if state is None else state.to(last.dtype)
        last = torch.where(active[:, None, None, None], last, keep)
        out = torch.where(active[:, None, None, None], out, out.new_zeros(()))
    if state_out is not None:
        last = state_out.copy_(last)
    return out, last


def _launch(r, k, v, w, u, state, state_out, chunked: bool, active=None):
    """Check the arguments and run one call of the chosen design."""
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
    if active is not None:
        if chunked:
            raise ValueError("wkv6: active rows are for the sequential design (decode)")
        _check("active", active, (b,), torch.bool, dev)
    if state_out is None:
        state_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev)
    else:
        _check("state_out", state_out, (b, h, dk, dv), torch.float32, dev)
    out = torch.empty((b, s, h, dv), dtype=r.dtype, device=dev)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if state is None else state.data_ptr(), out.data_ptr(), state_out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if chunked:
        # Scratch: each chunk's state contribution, then the state entering
        # it (B, H, C, K, V), and each chunk's decay (B, H, C, K).
        n = -(-s // CHUNK)
        scratch = torch.empty(b * h * n * dk * (dv + 1), dtype=torch.float32, device=dev)
        slots = scratch.data_ptr()
        err = _fn("wkv6_chunked_fwd")(
            _DTYPES[w.dtype], *ptrs, slots, slots + 4 * b * h * n * dk * dv,
            b, s, h, dk, dv, stream)
    else:
        err = _fn("wkv6_fwd")(_DTYPES[r.dtype], _DTYPES[w.dtype], *ptrs,
                              None if active is None else active.data_ptr(), b, s, h, dk, dv,
                              stream)
    if err:
        raise RuntimeError(f"wkv6 launch failed: cudaError {err}")
    return out, state_out


class WKV6Fn(torch.autograd.Function):
    """The kernel with a gradient: forward saving its inputs, backward by
    the backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        global launches
        out = _launch(r, k, v, w, u, state, None, uses_chunked(r.dtype, r.shape[1]))
        launches += 1
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, do, d_state):
        r, k, v, w, u, state = ctx.saved_tensors
        if do is None:
            do = torch.zeros(v.shape, dtype=r.dtype, device=r.device)
        return _bwd.wkv6_bwd(r, k, v, w, u, do.contiguous(), state,
                             None if d_state is None else d_state.contiguous())


def wkv6(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K)
    u: torch.Tensor,  # (H, K)
    state: Optional[torch.Tensor] = None,  # (B, H, K, V) float32; None = zeros
    *,
    state_out: Optional[torch.Tensor] = None,  # (B, H, K, V) float32
    active: Optional[torch.Tensor] = None,  # (B,) bool: rows stepped
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel that ``uses_chunked`` picks. CUDA tensors
    only: raises otherwise. Returns (o, last state). The last state goes to
    ``state_out`` when given, which may be ``state`` itself: the serving
    engine's arena is then updated in place. Through ``WKV6Fn`` when a
    gradient is required of an input; ``state_out`` is refused then."""
    global launches
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, state)):
        if state_out is not None:
            raise ValueError("wkv6: state_out (written in place) cannot take part in autograd; "
                             "pass state_out=None when a gradient is required")
        return WKV6Fn.apply(r, k, v, w, u, state)
    out = _launch(r, k, v, w, u, state, state_out, uses_chunked(r.dtype, r.shape[1]), active)
    launches += 1
    return out


def previous_design(r, k, v, w, u, state=None, *, state_out=None):
    """The sequential kernel on any shape (the only design before the
    chunked one), for side-by-side timing. Not counted in ``launches``;
    ``ops`` never calls it on the chunked shapes."""
    return _launch(r, k, v, w, u, state, state_out, chunked=False)


__all__ = ["WKV6Fn", "wkv6", "wkv6_plain", "launches", "uses_chunked", "previous_design"]
