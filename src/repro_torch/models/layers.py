"""Shared building blocks of the model zoo, in PyTorch.

Parameters are declared as ``Param`` specs (shape + logical axes +
initializer), as in ``repro.models.layers``; ``build_params`` turns a
spec tree (nested dicts and lists) into a tree of tensors drawn from an
explicit ``torch.Generator`` on an explicit device, so a full-width model
is made where it runs. The draws differ from JAX's for the same seed;
tests that compare the two packages convert JAX's parameters with
``repro_torch.interop`` instead.

Model code is functional: ``f(params, inputs) -> outputs`` on tensors,
with the JAX package's layouts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Param specs and trees
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | embed
    scale: Optional[float] = None  # override stddev

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    out: list = []
    map_tree(out.append, tree)
    return out


def fan_in(p: Param) -> int:
    """The input width of one layer's leaf, for its fan-in scaled init.

    A stacked leaf's leading ``layer`` axis is not an input axis. ``x @ W``
    contracts W's first axis, except an output projection
    (heads, head_dim, embed), which contracts all but its last. (The
    reference reads dim 1 of every 3-D leaf and dim 0 otherwise, so a
    stacked (n_super, d, heads, head_dim) leaf gets std 1/sqrt(n_super).)
    """
    shape, axes = p.shape, p.axes
    if axes and axes[0] == "layer":
        shape, axes = shape[1:], axes[1:]
    if len(shape) >= 3 and axes[-1] == "embed":
        return math.prod(shape[:-1])
    return max(shape[0], 1)


def _init_leaf(p: Param, dtype, device, generator: torch.Generator) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "embed":
        std = p.scale if p.scale is not None else 1.0
    else:
        std = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in(p))
    x = torch.randn(p.shape, generator=generator, dtype=dtype, device=device)
    return x.mul_(std)


def build_params(
    spec: Any, generator: torch.Generator, dtype=torch.float32, device="cuda"
) -> Any:
    """Materialize a spec tree into tensors, drawn in tree order from
    ``generator`` (which must live on ``device``)."""
    return map_tree(lambda p: _init_leaf(p, dtype, device, generator), spec)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layernorm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def norm_spec(d: int, kind: str) -> Dict[str, Param]:
    if kind == "rmsnorm":
        return {"scale": Param((d,), ("embed",), init="zeros")}
    return {
        "scale": Param((d,), ("embed",), init="ones"),
        "bias": Param((d,), ("embed",), init="zeros"),
    }


def apply_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    """Inverse frequencies for half the head dim."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim // 2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    sin = torch.sin(angles)[..., None, :]  # (B, S, 1, D/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_spec(d_model: int, d_ff: int, activation: str) -> Dict[str, Param]:
    if activation in ("swiglu", "geglu"):
        return {
            "gate": Param((d_model, d_ff), ("embed", "mlp")),
            "up": Param((d_model, d_ff), ("embed", "mlp")),
            "down": Param((d_ff, d_model), ("mlp", "embed")),
        }
    return {
        "up": Param((d_model, d_ff), ("embed", "mlp")),
        "up_bias": Param((d_ff,), ("mlp",), init="zeros"),
        "down": Param((d_ff, d_model), ("mlp", "embed")),
        "down_bias": Param((d_model,), ("embed",), init="zeros"),
    }


def apply_mlp(x: torch.Tensor, p: Dict[str, torch.Tensor], activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]
    if activation == "geglu":
        h = F.gelu(x @ p["gate"], approximate="tanh") * (x @ p["up"])
        return h @ p["down"]
    h = F.gelu(x @ p["up"] + p["up_bias"], approximate="tanh")
    return h @ p["down"] + p["down_bias"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_spec(vocab: int, d_model: int) -> Param:
    return Param((vocab, d_model), ("vocab", "embed"), init="embed", scale=0.02)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied unembedding in the model dtype, returned as float32 logits.
    (The reference accumulates to an f32 output; a bf16 product here
    accumulates in f32 and rounds the logits to bf16 before the cast.)"""
    return (x @ table.t()).float()
