"""What the plain float32 references share.

Each block family (``families/<name>.py``) computes what the port's
model of that family is meant to compute, from the same parameter tree,
with plain PyTorch operations in float32 and TF32 off: no kernel, no
cache, no batching tricks. Here are the parts they share: the layer's
leaves, the norms, the trunk run in exact float32, and the tied head.
Sequences of a batch are right-padded; every position depends on
earlier ones only, so a padded row's first ``length`` positions are
exact.

``convert`` turns each weight into the float32 the reference computes
with; the control passes one that rounds through a lower precision.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

Convert = Callable[[torch.Tensor], torch.Tensor]


def exact_float32() -> None:
    """Matrix products in true float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_float32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def layer_of(tree: Dict, i: int, convert: Convert) -> Dict:
    """Layer ``i``'s leaves, converted."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return convert(node[i])
    return walk(tree["super"][0])


def rms_norm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


@torch.no_grad()
def hidden(family, tree, tokens: torch.Tensor, dims: Dict,
           convert: Convert = to_float32) -> torch.Tensor:
    """Final normalised hidden states (B, S, D), float32, from the trunk
    of ``family`` (a module of ``families/``)."""
    exact_float32()
    return family.trunk(tree, tokens.long(), dims, convert)


@torch.no_grad()
def logits(tree, h: torch.Tensor, convert: Convert = to_float32) -> torch.Tensor:
    """The tied head on hidden states h (..., D): (..., V) float32."""
    return h @ convert(tree["embed"]).t()


def fp8_convert(t: torch.Tensor) -> torch.Tensor:
    """The control's weights: each tensor rounded through float8 e4m3 with
    one scale per tensor (its largest magnitude at 448), then computed in
    float32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def convert_for(precision: Optional[str]) -> Convert:
    if precision in (None, "float32"):
        return to_float32
    if precision == "fp8":
        return fp8_convert
    raise ValueError(f"unknown reference precision {precision!r}")
