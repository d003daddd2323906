"""Pluggable activation-sharding hook.

Model code may annotate activations with logical axis names via
``constrain(x, ("batch", "seq", "embed"))``. Outside any mesh this is the
identity. A distributed layer installs a resolver (``set_resolver``) that
maps logical axes to a device mesh and lays the tensor out there; the
port's sharding slice fills that in. Keeping the hook here keeps the
model code free of any distribution machinery.
"""
from __future__ import annotations

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
