"""Int8 error-feedback gradient compression for the cross-pod link:
``repro.training.compression`` in the port.

Only the pod-axis reduction is compressed (the slow edge of a multi-pod
mesh). Per leaf:

  1. add the carried error-feedback residual to the local gradient;
  2. per-block (BLOCK values of the flattened leaf) max-abs scales ->
     symmetric int8 codes, rounded half to even (``torch.round``, as
     ``jnp.round``);
  3. all_gather of the codes and the float32 scales over the pod group;
  4. dequantize and mean locally; residual = local gradient - its own
     quantized contribution (error feedback keeps the compression unbiased
     over time).

The pod axis is a ``torch.distributed`` process group, ``pod_group``.
``None`` means a single pod: the gather is the identity, as the
reference's own single-device test runs it. Nothing calls this yet on
the card: the train loop's cross-pod path waits for the sharding slice.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import map_tree, tree_leaves

BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., N) -> int8 codes (..., N / BLOCK, BLOCK) + float32 scales
    (..., N / BLOCK, 1); N is zero-padded to whole blocks."""
    n = x.shape[-1]
    xp = F.pad(x, (0, (-n) % BLOCK))
    xb = xp.reshape(x.shape[:-1] + (-1, BLOCK))
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return codes, scale.to(torch.float32)


def _dequantize(codes: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    xb = codes.to(torch.float32) * scale
    return xb.reshape(xb.shape[:-2] + (-1,))[..., :n]


def _all_gather(t: torch.Tensor, pod_group) -> torch.Tensor:
    """(P, ...) stack of every pod's ``t``; (1, ...) for a single pod."""
    if pod_group is None:
        return t[None]
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(dist.get_world_size(pod_group))]
    dist.all_gather(out, t.contiguous(), group=pod_group)
    return torch.stack(out)


def compressed_pod_mean(
    grad: torch.Tensor, residual: torch.Tensor, pod_group: Optional[Any] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce ``grad`` over the pods with int8 error feedback.
    Returns (reduced gradient float32, new residual)."""
    g = grad.to(torch.float32) + residual
    flat = g.reshape(-1)
    codes, scale = _quantize(flat)
    own = _dequantize(codes, scale, flat.shape[0])
    new_residual = (flat - own).reshape(grad.shape)
    all_codes = _all_gather(codes, pod_group)  # (P, nb, BLOCK) int8
    all_scales = _all_gather(scale, pod_group)
    n_pods = all_codes.shape[0]
    total = torch.sum(all_codes.to(torch.float32) * all_scales, dim=0)
    mean = (total.reshape(-1)[: flat.shape[0]] / n_pods).reshape(grad.shape)
    return mean, new_residual


def compress_tree_pod_mean(
    grads: Any, residuals: Any, pod_group: Optional[Any] = None
) -> Tuple[Any, Any]:
    out = [compressed_pod_mean(g, r, pod_group)
           for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
    it_mean = iter([o[0] for o in out])
    it_res = iter([o[1] for o in out])
    return (map_tree(lambda _: next(it_mean), grads),
            map_tree(lambda _: next(it_res), grads))


def init_residuals(params: Any) -> Any:
    return map_tree(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
