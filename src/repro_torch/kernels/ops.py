"""Device dispatch for the kernels.

The model code calls these (``cfg.impl`` ``"xla"`` or ``"pallas"``). A
CUDA tensor goes to the hand-written Hopper kernel, a CPU tensor to the
kernel's plain PyTorch version; anything else raises. There is no
fallback: a CUDA tensor either launches the kernel or the call raises.
This replaces the JAX package's interpret-mode switch.

Gradients: on the CPU every plain version is differentiable by autograd.
On the card, flash attention, ``wkv6`` and ``rglru_scan`` have backward
kernels (``flash_attention.FlashAttentionFn``, ``wkv6.WKV6Fn``,
``rglru.RGLRUScanFn``), which the wrappers take when autograd is
recording and an input requires a gradient; under ``no_grad`` they make
the same call as before and save nothing. ``decode_attention`` has none
(training never decodes) and raises a ``RuntimeError`` then, rather than
give a loss that no gradient flows back through (a plain version never
stands in).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import rglru_bwd as _rglru_bwd
from repro_torch.kernels import wkv6 as _wkv6
from repro_torch.kernels import wkv6_bwd as _wkv6_bwd

_KERNELS = {
    "decode_attention": _decode,
    "flash_attention": _flash,
    "flash_attention_bwd": _flash_bwd,
    "wkv6": _wkv6,
    "wkv6_bwd": _wkv6_bwd,
    "rglru_scan": _rglru,
    "rglru_bwd": _rglru_bwd,
}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


# Why a kernel without a backward refuses a gradient on the card.
_NO_BACKWARD = {
    "decode_attention": "decode_attention has no backward kernel: training never decodes",
}


def _refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would need the gradient of a kernel that has no
    backward: recording, and an input requires a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{_NO_BACKWARD[name]}; a gradient was required of it on the card "
                           "(run under torch.no_grad(), or on CPU tensors)")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_pos: Optional[torch.Tensor] = None,  # (B, S) int32; None = arange
    kv_pos: Optional[torch.Tensor] = None,  # (B, S_kv) int32
) -> torch.Tensor:
    """Prefill (or cross-) attention; see ``kernels/flash_attention.py``
    for the masks and the positions' precondition."""
    kw = dict(causal=causal, window=window, q_pos=q_pos, kv_pos=kv_pos)
    if _on_cuda(q):
        return _flash.flash_attention(q, k, v, **kw)
    return _flash.flash_attention_plain(q, k, v, **kw)


def decode_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cursor: torch.Tensor,
    kv_pos: torch.Tensor,
    kv_valid: torch.Tensor,
    active: Optional[torch.Tensor] = None,  # (B,) live-slot bitmap (arena)
    *,
    window: Optional[int] = None,
    causal: bool = True,
) -> torch.Tensor:
    if _on_cuda(q):
        _refuse_grad("decode_attention", q, cache_k, cache_v)
        fn = _decode.decode_attention
    else:
        fn = _decode.decode_attention_plain
    return fn(q, cache_k, cache_v, cursor, kv_pos, kv_valid, active, window=window,
              causal=causal)


def rglru_scan(
    a: torch.Tensor,  # (B, S, D)
    b: torch.Tensor,
    h0: Optional[torch.Tensor] = None,  # (B, D) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cuda(a):
        return _rglru.rglru_scan(a, b, h0)
    return _rglru.rglru_scan_plain(a, b, h0)


def wkv6(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K)
    u: torch.Tensor,  # (H, K)
    state: Optional[torch.Tensor] = None,  # (B, H, K, V) float32
    *,
    state_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``state_out`` (optional, may be ``state``) receives the last state
    in place: the kernel writes it there directly, the plain path copies.
    The kernel refuses it when a gradient is required."""
    if _on_cuda(r):
        return _wkv6.wkv6(r, k, v, w, u, state, state_out=state_out)
    return _wkv6.wkv6_plain(r, k, v, w, u, state, state_out=state_out)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` to the launch counters, by kernel name. A CUDA-graph
    replay runs no Python, so the serving engine adds each replay's
    captured launches here: the counters then mean what they mean for
    eager calls, one count per wrapper call that reached the device."""
    for name, n in counts.items():
        _KERNELS[name].launches += n
