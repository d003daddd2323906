"""Mixture-of-Experts FFN with capacity-based dispatch, in PyTorch.

Routing is top-k softmax (mixtral: k=2 over 8 experts; llama4-maverick:
k=1 over 128 experts + a shared expert), as in ``repro.models.moe``'s
global path. Tokens are ranked within their expert group in (token,
choice) order and dropped beyond the static capacity, so every shape is
fixed by the token count alone; the experts run as stacked batched
products over an (E, C, d) buffer.

Every step here is free of host syncs, so a decode step holding it
captures as one CUDA graph: the capacity is a Python int computed from
the static token count, group sizes and ranks come from a cumulative
sum over a fixed-width one-hot (no ``bincount``, ``nonzero`` or boolean
indexing), and the top-k choice is a stable descending sort, which
takes the lower expert first on ties as ``jax.lax.top_k`` does
(``torch.topk`` promises no order among equal values).

The reference's combine scatter-adds each kept term into a zero output
in x.dtype. Here each (token, choice) gathers its own term through its
slot (a dropped one reads a zero row), rounded per term in x.dtype, and
the k terms are added to a zero start in choice order: deterministic
for any k, and equal bit for bit to the reference's sum for k <= 2,
where the order of two additions to zero cannot matter.

On a mesh (``sharding_hooks.set_moe_mesh``), when the batch divides the
data axes, ``apply_moe`` takes the local path, the counterpart of the
reference's ``shard_map`` (``_apply_moe_local``): each data shard routes
its own tokens through the global path with no collective of its own.
The weights' FSDP-sharded dims are all-gathered over the data axes by a
differentiable functional collective (its transpose, in the backward, is
a reduce-scatter); the router is gathered whole, so routing runs on
plain tensors; the expert products stay DTensors on the model axis
(expert parallelism, or tensor parallelism inside each expert, by the
rules). ``aux`` is averaged over the data axes. A plain input (the
whole batch on every rank) gives plain outputs, gathered whole.
``local_calls`` counts the path's calls.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import local_region
from repro_torch.models.layers import Param, apply_mlp, mlp_spec
from repro_torch.models.sharding_hooks import constrain, moe_mesh, replicate, reshape

local_calls = 0


def moe_spec(
    d_model: int,
    d_ff: int,
    n_experts: int,
    activation: str,
    shared_expert: bool,
) -> Dict:
    spec = {
        "router": Param((d_model, n_experts), ("embed", "expert"), scale=0.02),
        "gate": Param((n_experts, d_model, d_ff), ("expert", "embed", "mlp")),
        "up": Param((n_experts, d_model, d_ff), ("expert", "embed", "mlp")),
        "down": Param((n_experts, d_ff, d_model), ("expert", "mlp", "embed")),
    }
    if shared_expert:
        spec["shared"] = mlp_spec(d_model, d_ff, activation)
    return spec


def _route(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """(probs (T, E), top_w (T, k) renormalised, top_e (T, k)), float32."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = sorted_p[:, :top_k], order[:, :top_k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_e


class Dispatch(NamedTuple):
    """One call's routing decisions, per (token, choice) in that order."""

    top_e: torch.Tensor  # (T, k) expert ids
    top_w: torch.Tensor  # (T, k) float32 weights, renormalised
    keep: torch.Tensor  # (T * k,) place within the expert's group < capacity
    slot: torch.Tensor  # (T * k,) row of the (E * C + 1, d) buffer; E * C drops
    capacity: int
    aux: torch.Tensor  # () float32 load-balancing loss


def dispatch_plan(
    router: torch.Tensor, xf: torch.Tensor, *, top_k: int,
    capacity_factor: float = 1.25, min_capacity: int = 4,
) -> Dispatch:
    """Routing, the Switch aux loss and the capacity decisions for the
    (T, d) tokens ``xf``. A token's rank in its expert's group is its
    place among the group's (token, choice) pairs in that order: the
    reference's stable sort by expert keeps exactly that order."""
    t = xf.shape[0]
    e = router.shape[1]
    probs, top_w, top_e = _route(router, xf, top_k)
    hot = top_e[..., None] == torch.arange(e, device=xf.device)  # (T, k, E)
    aux = e * torch.sum(probs.mean(0) * hot.float().sum(1).mean(0))
    # Rows per expert, a Python int from the static token count.
    capacity = max(min_capacity, int(math.ceil(t * top_k / e * capacity_factor)))
    flat_e = top_e.reshape(-1)
    flat_hot = hot.reshape(t * top_k, e).long()
    rank = (flat_hot.cumsum(0) - flat_hot).gather(1, flat_e[:, None])[:, 0]
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, torch.full_like(rank, e * capacity))
    return Dispatch(top_e, top_w, keep, slot, capacity, aux)


def _activate(activation: str, p: Dict, x: torch.Tensor, eq: str) -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(torch.einsum(eq, x, p["gate"])) * torch.einsum(eq, x, p["up"])
    if activation == "geglu":
        return F.gelu(torch.einsum(eq, x, p["gate"]), approximate="tanh") * torch.einsum(
            eq, x, p["up"])
    return F.gelu(torch.einsum(eq, x, p["up"]), approximate="tanh")


def apply_moe(
    p: Dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    top_k: int,
    activation: str,
    capacity_factor: float = 1.25,
    min_capacity: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). aux_loss is the standard load-balancing
    loss (mean over experts of fraction_tokens * fraction_probs * E).

    When a mesh is installed (``sharding_hooks.set_moe_mesh``) and the
    batch divides the data axes, dispatch runs in the local path;
    otherwise the reference's global path
    (``repro.models.moe._apply_moe_global``)."""
    mesh = moe_mesh()
    kw = dict(top_k=top_k, activation=activation, capacity_factor=capacity_factor,
              min_capacity=min_capacity)
    if mesh is not None:
        data_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        n_shards = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in data_axes)
        if data_axes and x.shape[0] % n_shards == 0 and x.shape[0] >= n_shards:
            return _apply_moe_local(p, x, mesh, data_axes, **kw)
    return _apply_moe_global(p, x, **kw)


def _dtensor(t: torch.Tensor, mesh):
    """``t`` as a DTensor on ``mesh`` (a plain tensor counts as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _apply_moe_local(p: Dict, x: torch.Tensor, mesh, data_axes, *, top_k: int,
                     activation: str, capacity_factor: float, min_capacity: int):
    """The local path: routing per data shard, FSDP dims gathered."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    # The same differentiable all_gather under its newer name where it has one.
    all_gather = getattr(funcol, "all_gather_single_autograd", None) or \
        funcol.all_gather_tensor_autograd
    global local_calls
    local_calls += 1
    names = mesh.mesh_dim_names
    model = mesh["model"] if "model" in names else None
    data_dims = [names.index(a) for a in data_axes]
    # Innermost mesh dim first: DTensor lays a dim sharded over several
    # mesh dims out in mesh-dim order, so this rebuilds it in order.
    gather_order = sorted(data_dims, reverse=True)

    def gather(w, whole=False):
        w = _dtensor(w, mesh)
        t = w.to_local()
        for i in gather_order:
            pl = w.placements[i]
            if isinstance(pl, Shard):
                t = all_gather(t, pl.dim, mesh.get_group(i))
        if model is None:
            return t
        on_model = w.placements[names.index("model")]
        if not isinstance(on_model, Shard):
            on_model = Replicate()
        wm = DTensor.from_local(t, model, [on_model], run_check=False)
        return wm.full_tensor() if whole else wm

    full = {name: gather(p[name], whole=(name == "router")) for name in ("router", "gate", "up",
                                                                        "down") if name in p}
    if "shared" in p:
        full["shared"] = {k: gather(v) for k, v in p["shared"].items()}
    x_layout = [Shard(0) if i in data_dims else Replicate() for i in range(mesh.ndim)]
    x_loc = _dtensor(x, mesh).redistribute(mesh, x_layout).to_local()
    with local_region(math.prod(mesh.size(i) for i in data_dims)):
        out, aux = _apply_moe_global(full, x_loc, top_k=top_k, activation=activation,
                                     capacity_factor=capacity_factor,
                                     min_capacity=min_capacity, use_constraints=False,
                                     expert_mesh=model)
    out = DTensor.from_local(out, mesh, x_layout, run_check=False)
    # aux is each shard's mean; the data axes average it.
    aux = DTensor.from_local(
        aux, mesh, [Partial("avg") if i in data_dims else Replicate() for i in range(mesh.ndim)],
        run_check=False)
    if not isinstance(x, DTensor):  # plain in, plain out (whole on every rank)
        return out.full_tensor(), aux.full_tensor()
    return out, aux


def _experts(t: torch.Tensor, expert_mesh):
    """Inside the local path: a plain (replicated) tensor as a DTensor on
    the model axis, for the products with the model-sharded weights."""
    if expert_mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, expert_mesh, [Replicate()], run_check=False)


def _plain(t: torch.Tensor) -> torch.Tensor:
    """Inside the local path: a model-axis DTensor gathered to a plain
    tensor."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim).to_local()


def _apply_moe_global(
    p: Dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    top_k: int,
    activation: str,
    capacity_factor: float = 1.25,
    min_capacity: int = 4,
    use_constraints: bool = True,
    expert_mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's global path. ``expert_mesh`` (the local path's
    model axis) runs the expert products as DTensors there."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    t = b * s
    # On a mesh the global path routes every token on every rank (DTensor
    # has no sharded sort or gather by data-dependent indices), as GSPMD
    # replicates the reference's; the local path is what avoids that.
    xf = replicate(reshape(x, t, d))
    plan = dispatch_plan(p["router"], xf, top_k=top_k, capacity_factor=capacity_factor,
                         min_capacity=min_capacity)
    c = plan.capacity
    tok = torch.arange(t * top_k, device=x.device) // top_k
    # Kept slots are distinct; only the discarded drop row is written twice.
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, plan.slot, xf[tok])
    xe = reshape(buf[:-1], e, c, d)
    if use_constraints:
        xe = constrain(xe, ("expert", None, "embed"))
    xe = _experts(xe, expert_mesh)
    h = _activate(activation, p, xe, "ecd,edf->ecf")
    ye = torch.einsum("ecf,efd->ecd", h, p["down"])
    if expert_mesh is not None:
        ye = _plain(ye)
    if use_constraints:
        ye = constrain(ye, ("expert", None, "embed"))
    yflat = torch.cat([reshape(ye, e * c, d), ye.new_zeros((1, d))])
    terms = (yflat[plan.slot] * plan.top_w.reshape(-1, 1).to(x.dtype)).reshape(t, top_k, d)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        out = out + terms[:, j]
    if "shared" in p:
        shared = apply_mlp(_experts(xf, expert_mesh), p["shared"], activation)
        out = out + (_plain(shared) if expert_mesh is not None else shared)
    return reshape(out, b, s, d), plan.aux


def apply_moe_dense_reference(
    p: Dict, x: torch.Tensor, *, top_k: int, activation: str
) -> torch.Tensor:
    """Oracle: every token through every expert, weighted by the top-k
    router weights (no capacity drops)."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    xf = x.reshape(-1, d)
    _, top_w, top_e = _route(p["router"], xf, top_k)
    weights = torch.zeros((xf.shape[0], e), dtype=torch.float32, device=x.device)
    weights.scatter_(1, top_e, top_w)
    h = _activate(activation, p, xf, "td,edf->tef")
    ye = torch.einsum("tef,efd->ted", h, p["down"])
    out = torch.einsum("ted,te->td", ye.float(), weights).to(x.dtype)
    if "shared" in p:
        out = out + apply_mlp(xf, p["shared"], activation)
    return out.reshape(b, s, d)
