"""Pluggable activation-sharding hook.

Model code may annotate activations with logical axis names via
``constrain(x, ("batch", "seq", "embed"))``. Outside any mesh this is the
identity. The distributed layer (``repro_torch.distributed.sharding``)
installs a resolver (``set_resolver``) that maps logical axes to mesh
axes and redistributes a DTensor activation to that layout. Keeping the
hook here avoids a models -> distributed import cycle and keeps the
model code free of any distribution machinery.

The helpers below (``replicate``, ``unshard``, ``flattenable``,
``reshape``, ``pad_front``) are the identity's plain counterparts on
plain tensors. On DTensors they lay a tensor out so that the op after
them can run at all: DTensor plans each op's layout by itself (GSPMD
plans the whole program), and some of its layouts (a strided shard, a
sequence shard into a pad) have no product or no plan. Last, the MoE
mesh hook (``set_moe_mesh``) selects MoE's local path.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch

Resolver = Callable[[torch.Tensor, Tuple[Optional[str], ...]], torch.Tensor]

_RESOLVER: Optional[Resolver] = None


def set_resolver(fn: Optional[Resolver]) -> None:
    global _RESOLVER
    _RESOLVER = fn


def clear_resolver() -> None:
    set_resolver(None)


def constrain(x: torch.Tensor, axes: Tuple[Optional[str], ...]) -> torch.Tensor:
    if _RESOLVER is None:
        return x
    return _RESOLVER(x, axes)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole onto every rank of its mesh (still a
    DTensor); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or all(p.is_replicate() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def pad_front(x: torch.Tensor, n: int) -> torch.Tensor:
    """``F.pad(x, (0, 0, n, 0))``: n zero steps before dim 1 of a (B, S, D)
    tensor. A DTensor is padded shard by shard, its sequence gathered
    whole first (DTensor's own pad fails to plan its redistribution)."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return F.pad(x, (0, 0, n, 0))
    x = unshard(x, 1)
    return DTensor.from_local(F.pad(x.to_local(), (0, 0, n, 0)), x.device_mesh, x.placements,
                              run_check=False)


def unshard(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """A DTensor gathered on tensor dims ``dims`` (its other shards kept);
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    nd = x.dim()
    want = [Replicate() if isinstance(pl, Shard) and pl.dim % nd in {d % nd for d in dims}
            else pl for pl in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def flattenable(x: torch.Tensor, first: int, last: int) -> torch.Tensor:
    """``x`` ready to flatten dims ``first..last`` into one: a DTensor
    sharded on a dim after ``first`` in that run is gathered on it (a
    flattened dim can carry its leading dim's shard only; DTensor has no
    product for the strided shard the others would make)."""
    return unshard(x, *range(first + 1, last + 1))


def _odd(pl) -> bool:
    """A placement that is none of replicate, pending sum or plain shard: a
    strided shard (whose class is not ``Shard``'s in every torch)."""
    from torch.distributed.tensor import Shard

    return not pl.is_replicate() and not pl.is_partial() and type(pl) is not Shard


def _reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """Reshape a DTensor so that no dim ends up with a strided shard (a
    flattened dim holding a later dim's shard), which DTensor's products
    cannot take: gather the dims past the batch first, then all."""
    from torch.distributed.tensor import Replicate, Shard

    def attempt(t):
        try:
            out = t.reshape(*shape)
        except RuntimeError as e:
            if "shard" not in str(e).lower():
                raise
            return None
        return None if any(_odd(pl) for pl in out.placements) else out

    out = attempt(x)
    if out is None:
        inner = [Replicate() if _odd(pl) or (type(pl) is Shard and pl.dim != 0) else pl
                 for pl in x.placements]
        out = attempt(x.redistribute(x.device_mesh, inner))
    return out if out is not None else replicate(x).reshape(*shape)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward reshapes the gradient the same
    careful way (autograd's own view backward would not)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return _reshape(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshape(grad, ctx.shape), None


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``; a DTensor whose shards the new shape cannot
    keep (a dim split into sizes the mesh does not divide) is first
    gathered on its dims past the batch, then on all, forwards and
    backwards. A plain tensor is reshaped as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


# --- remat under the forward's mode ---------------------------------------
# A checkpointed layer's recompute runs in the backward, outside whatever
# mode the forward ran under; ``remat_contexts`` (torch.utils.checkpoint's
# ``context_fn``) re-enters the mode ``set_remat_context`` installed.
_REMAT_CONTEXT: Optional[Callable[[], contextlib.AbstractContextManager]] = None


def set_remat_context(fn) -> None:
    global _REMAT_CONTEXT
    _REMAT_CONTEXT = fn


def remat_contexts():
    """(forward context, recompute context) for ``checkpoint(context_fn=...)``."""
    return contextlib.nullcontext(), (
        _REMAT_CONTEXT() if _REMAT_CONTEXT is not None else contextlib.nullcontext())


# --- MoE mesh context ---------------------------------------------------------
# When a mesh is installed, moe.apply_moe takes the local-dispatch path:
# token routing runs per data shard with no collective of its own; only
# the weights' FSDP shards are gathered.
_MOE_MESH = None


def set_moe_mesh(mesh) -> None:
    global _MOE_MESH
    _MOE_MESH = mesh


def clear_moe_mesh() -> None:
    set_moe_mesh(None)


def moe_mesh():
    return _MOE_MESH
