"""AdamW in plain PyTorch, with the cosine schedule and global-norm
clipping: ``repro.training.optimizer`` in the port.

The optimizer state mirrors the parameter tree: m and v in float32,
``step`` a () int32 tensor. The update is computed in float32 and cast
back to each parameter's dtype; there is no float32 master copy of the
parameters (the reference keeps none). No kernel: the reference's
optimizer is plain ``jnp`` too.

One departure from the reference, for memory: ``update`` writes the new
parameters, m and v IN PLACE (the port may update in place where that
saves memory; at granite-3-2b's full width m and v are 10.1 GB each) and
returns the same tensors in the new trees. Call it under
``torch.no_grad()`` when the parameters require gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import map_tree, tree_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine decay to ``min_lr_ratio``
    of it at ``total_steps``; float32, on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(params: Any) -> AdamWState:
    """Zero m and v (float32, beside each parameter) and step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=map_tree(zeros, params), v=map_tree(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def update(
    cfg: AdamWConfig,
    grads: Any,
    state: AdamWState,
    params: Any,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns (params, new_state, metrics) with
    ``grad_norm`` (before clipping) and ``lr``. ``params``, ``state.m`` and
    ``state.v`` are updated in place; ``grads`` is read only."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        # The reference's arithmetic, one float32 rounding per operation:
        # g32 = g * scale; m = b1 m + (1 - b1) g32; v = b2 v + (1 - b2) g32^2;
        # p = p - lr (m / b1c / (sqrt(v / b2c) + eps) + wd p).
        g32 = g.float() * scale if scale is not None else g.to(torch.float32, copy=True)
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
        del g32
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        p32 = p.float()
        delta.add_(p32 * cfg.weight_decay)
        p.copy_((p32 - delta.mul_(lr)).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
