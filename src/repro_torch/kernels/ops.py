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

On a mesh (DTensor arguments) each kernel runs on every rank's local
shard, the view of the reference's ``shard_map``: ``mesh_call`` keeps a
placement only where it splits dims the kernel treats independently
(batch rows, or whole query/KV head groups; an rglru channel),
redistributes every other placement (a sharded head_dim or sequence, a
pending sum) to one the kernel can take (that collective is DTensor's,
and counted as such), runs the same call on ``to_local()`` and wraps the
result back with ``from_local``. Both are differentiable, so the
backward kernels run the same way. A ``meta`` or fake tensor raises: no
kernel runs on it.

``ssd_chunk`` and ``ssd_step`` (Mamba-2's prefill and decode) route the
same way to ``kernels/ssd_chunk.py`` / ``ssd_step.py`` or to their plain
twins (``ref.ssd_chunk_plain``, ``ref.ssd_step_plain``); neither has a
backward kernel, so a gradient through them on the card raises (training
the kind goes through autograd of the twins, off the card).

``rownorm`` (the model's RMS and layer norms) routes like the others:
the model calls it for every impl but ``"dense"``, which runs the plain
chain itself. Its gradient on the card is ``rownorm.RownormFn``, whose
backward differentiates the plain chain (no backward kernel); on a mesh
every dim but the last is a row dim it keeps.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import local_region
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import rglru_bwd as _rglru_bwd
from repro_torch.kernels import rownorm as _rownorm
from repro_torch.kernels import ssd_chunk as _ssd_chunk
from repro_torch.kernels import ssd_step as _ssd_step
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
    "rownorm": _rownorm,
    "ssd_chunk": _ssd_chunk,
    "ssd_step": _ssd_step,
}


def _on_cuda(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(t):
        raise ValueError("no kernel runs on a fake tensor")
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


# Per argument, the dims a kernel treats independently, by role.
_BATCH_HEADS = {"batch": 0, "heads": 2}  # (B, S, H, D) and (B, S, KV, D)
_BATCH = {"batch": 0}


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


class _StridedGrad(torch.autograd.Function):
    """The identity, whose gradient takes its input's strides: a local
    shard's gradient goes back into a DTensor that keeps the forward's
    stride metadata, so a gradient laid out otherwise would mislead the
    DTensor ops (views) after it."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.shape, x.stride())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        shape, stride = ctx.layout
        if grad.stride() == stride:
            return grad
        return torch.empty_strided(shape, stride, dtype=grad.dtype,
                                   device=grad.device).copy_(grad)


def mesh_call(fn, args, dims, out_dims):
    """``fn(*local shards)`` on every rank; returns DTensors.

    ``dims[j]`` maps roles to argument j's dims and ``out_dims[k]`` to
    output k's. A mesh dim keeps the first DTensor argument's ``Shard``
    when that shards a role every argument with the role can split evenly
    there; every other mesh dim is replicated. Plain tensor arguments
    count as replicated. An argument without the role a mesh dim keeps
    (a norm's weight beside batch-sharded rows) is used whole by every
    rank of that dim on its own shard, so its gradient is the sum over
    them (``Partial``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    j = next(j for j, a in enumerate(args) if is_dtensor(a))
    lead, lead_dims = args[j], dims[j]
    mesh = lead.device_mesh
    roles, split = [], {}
    for i, pl in enumerate(lead.placements):
        role = None
        if type(pl) is Shard:
            role = next((r for r, d in lead_dims.items() if d == pl.dim), None)
        if role is not None:
            n = split.get(role, 1) * mesh.size(i)
            if all(a.shape[dm[role]] % n == 0 for a, dm in zip(args, dims)
                   if a is not None and role in dm):
                split[role] = n
            else:
                role = None
        roles.append(role)

    def layout(dm):
        return [Shard(dm[r]) if r in dm else Replicate() for r in roles]

    local = []
    for a, dm in zip(args, dims):
        if a is None:
            local.append(None)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        want = layout(dm)
        if tuple(a.placements) != tuple(want):
            a = a.redistribute(mesh, want)
        grads = [Partial() if r is not None and r not in dm else pl
                 for r, pl in zip(roles, want)]
        t = a.to_local(grad_placements=grads)
        local.append(_StridedGrad.apply(t) if t.requires_grad else t)
    with local_region(math.prod(split.values())):
        out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(
        None if o is None else DTensor.from_local(o.contiguous(), mesh, layout(dm),
                                                  run_check=False)
        for o, dm in zip(outs, out_dims))
    return wrapped if isinstance(out, tuple) else wrapped[0]


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
    if is_dtensor(q) or is_dtensor(k):
        return mesh_call(
            lambda *a: flash_attention(*a[:3], causal=causal, window=window, q_pos=a[3],
                                       kv_pos=a[4]),
            [q, k, v, q_pos, kv_pos], [_BATCH_HEADS] * 3 + [_BATCH] * 2, [_BATCH_HEADS])
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
    if is_dtensor(q) or is_dtensor(cache_k):
        return mesh_call(
            lambda *a: decode_attention(*a, window=window, causal=causal),
            [q, cache_k, cache_v, cursor, kv_pos, kv_valid, active],
            [_BATCH_HEADS] * 3 + [_BATCH] * 4, [_BATCH_HEADS])
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
    if is_dtensor(a) or is_dtensor(b):
        seq, last = {"batch": 0, "heads": 2}, {"batch": 0, "heads": 1}
        return mesh_call(rglru_scan, [a, b, h0], [seq, seq, last], [seq, last])
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
    active: Optional[torch.Tensor] = None,  # (B,) bool: rows stepped
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``state_out`` (optional, may be ``state``) receives the last state
    in place: the kernel writes it there directly, the plain path copies.
    The kernel refuses it when a gradient is required. On a mesh each
    rank's shard runs the kernel and ``state_out`` is then copied into.
    ``active`` (decode) marks the rows stepped: a held row's state is
    left as it was (``state_out`` takes the state it came in with) and
    its output is 0."""
    if any(is_dtensor(t) for t in (r, k, v, w, u, state, active)):
        st = {"batch": 0, "heads": 1}
        out, new = mesh_call(lambda *a: wkv6(*a[:6], active=a[6]), [r, k, v, w, u, state, active],
                             [_BATCH_HEADS] * 4 + [{"heads": 0}, st, {"batch": 0}],
                             [_BATCH_HEADS, st])
        if state_out is not None:
            state_out.copy_(new)
            new = state_out
        return out, new
    fn = _wkv6.wkv6 if _on_cuda(r) else _wkv6.wkv6_plain
    return fn(r, k, v, w, u, state, state_out=state_out, active=active)


def rownorm(
    x: torch.Tensor,  # (..., d)
    w: torch.Tensor,  # (d,)
    b: Optional[torch.Tensor] = None,  # (d,), layer norm only
    *,
    eps: float,
    center: bool,
    gate: Optional[torch.Tensor] = None,  # x's shape: RMS norm of x * silu(gate)
) -> torch.Tensor:
    """Layer norm when ``center``, else RMS norm with weight ``1 + w``,
    over x's last dim (of ``x * silu(gate)`` with a gate); see
    ``kernels/rownorm.py``."""
    if is_dtensor(x) or is_dtensor(w) or is_dtensor(b) or is_dtensor(gate):
        rows = {f"row{i}": i for i in range(x.dim() - 1)}
        return mesh_call(lambda *a: rownorm(*a[:3], eps=eps, center=center, gate=a[3]),
                         [x, w, b, gate], [rows, {}, {}, rows], [rows])
    if _on_cuda(x):
        return _rownorm.rownorm(x, w, b, eps=eps, center=center, gate=gate)
    return _rownorm.rownorm_plain(x, w, b, eps=eps, center=center, gate=gate)


def ssd_chunk(xbc, conv_w, conv_b, dt, dt_bias, a_log, d, *, state_size: int,
              last_state: bool = True):
    """Mamba-2's prefill from a zero state, its conv included: (y (B, S, H,
    P), last state (B, H, P, N) float32 or None); see
    ``kernels/ssd_chunk.py``. (The meshed dry run takes ``impl="dense"``,
    which does not come here.)"""
    args = [xbc, conv_w, conv_b, dt, dt_bias, a_log, d]
    if _on_cuda(xbc):
        return _ssd_chunk.ssd_chunk(*args, state_size=state_size, last_state=last_state)
    return _ssd_chunk.ssd_chunk_plain(*args, state_size=state_size)


def ssd_step(xbc, dt, conv_state, conv_w, conv_b, dt_bias, a_log, d, state, active=None):
    """One decode token of Mamba-2's mixer over every arena row, both
    states in place on the ``active`` rows; see ``kernels/ssd_step.py``."""
    fn = _ssd_step.ssd_step if _on_cuda(xbc) else _ssd_step.ssd_step_plain
    return fn(xbc, dt, conv_state, conv_w, conv_b, dt_bias, a_log, d, state, active)


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
