"""Device dispatch for the kernels.

The model code calls these (``cfg.impl`` ``"xla"`` or ``"pallas"``). A
CUDA tensor goes to the hand-written Hopper kernel, a CPU tensor to the
kernel's plain PyTorch version; anything else raises. There is no
fallback: a CUDA tensor either launches the kernel or the call raises.
This replaces the JAX package's interpret-mode switch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import wkv6 as _wkv6

_KERNELS = {
    "decode_attention": _decode,
    "flash_attention": _flash,
    "wkv6": _wkv6,
    "rglru_scan": _rglru,
}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: Optional[torch.Tensor] = None,  # (B, S) — must be arange
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Prefill attention. The kernel assumes arange positions
    (left-aligned prefill); ``positions`` is accepted and not read."""
    if _on_cuda(q):
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return _flash.flash_attention_plain(q, k, v, causal=causal, window=window)


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
) -> torch.Tensor:
    if _on_cuda(q):
        return _decode.decode_attention(
            q, cache_k, cache_v, cursor, kv_pos, kv_valid, active, window=window
        )
    return _decode.decode_attention_plain(
        q, cache_k, cache_v, cursor, kv_pos, kv_valid, active, window=window
    )


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
    in place: the kernel writes it there directly, the plain path copies."""
    if _on_cuda(r):
        return _wkv6.wkv6(r, k, v, w, u, state, state_out=state_out)
    return _wkv6.wkv6_plain(r, k, v, w, u, state, state_out=state_out)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
