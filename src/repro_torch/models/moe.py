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

The reference's ``shard_map`` local path (expert parallelism over a
mesh) belongs to the sharding slice and is not here.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Param, apply_mlp, mlp_spec


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
    """Returns (output, aux_loss): the reference's global path
    (``repro.models.moe._apply_moe_global``). aux_loss is the standard
    load-balancing loss (mean over experts of fraction_tokens *
    fraction_probs * E)."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    t = b * s
    xf = x.reshape(t, d)
    plan = dispatch_plan(p["router"], xf, top_k=top_k, capacity_factor=capacity_factor,
                         min_capacity=min_capacity)
    c = plan.capacity
    tok = torch.arange(t * top_k, device=x.device) // top_k
    # Kept slots are distinct; only the discarded drop row is written twice.
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, plan.slot, xf[tok])
    xe = buf[:-1].reshape(e, c, d)
    h = _activate(activation, p, xe, "ecd,edf->ecf")
    ye = torch.einsum("ecf,efd->ecd", h, p["down"])
    yflat = torch.cat([ye.reshape(e * c, d), ye.new_zeros((1, d))])
    terms = (yflat[plan.slot] * plan.top_w.reshape(-1, 1).to(x.dtype)).reshape(t, top_k, d)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        out = out + terms[:, j]
    if "shared" in p:
        out = out + apply_mlp(xf, p["shared"], activation)
    return out.reshape(b, s, d), plan.aux


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
