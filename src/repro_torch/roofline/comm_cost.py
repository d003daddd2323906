"""Collective counts by kind and bytes per executed call: the port's
counterpart of ``repro.roofline.hlo_cost`` (which parses the compiled
per-device HLO text for collectives and while-loop trip counts).

Eager code executes every collective it needs, each as a call of a
``torch.distributed`` functional collective (what DTensor's
redistributions issue) or a c10d op, so there is no text to parse and no
trip count to recover: each call counts once, at its operand bytes on
this rank (the reference's rule: the operand sizes of every all-gather,
all-reduce, reduce-scatter, all-to-all and collective-permute), with the
call count beside it. ``CollectiveCount`` does the counting for
``op_cost.OpCost``; ``CollectiveCounter`` is the same as a dispatch mode
of its own. Both work on a fake process group (the dry run), where the
collectives move nothing.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# Op-name stems (of ``_c10d_functional`` and ``c10d``) by kind.
_STEMS = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
)


def kind_of(func) -> Optional[str]:
    """The collective kind of an op, or None."""
    ns = func.namespace if hasattr(func, "namespace") else ""
    if ns not in ("_c10d_functional", "c10d_functional", "c10d", "_c10d_functional_autograd"):
        return None
    name = func.overloadpacket.__name__ if hasattr(func, "overloadpacket") else str(func)
    for stem, kind in _STEMS:
        if name.startswith(stem):
            return kind
    return None


class CollectiveCount:
    def __init__(self):
        self.bytes: Dict[str, float] = {k: 0.0 for k in KINDS}
        self.calls: Dict[str, int] = {k: 0 for k in KINDS}

    def note(self, func, operands: List[torch.Tensor]) -> None:
        kind = kind_of(func)
        self.calls[kind] += 1
        # The first tensor is (or heads the list of) what this rank sends;
        # a list-valued op's output buffers follow it.
        t = operands[0]
        self.bytes[kind] += float(math.prod(t.shape) * t.element_size())

    def result(self) -> Dict[str, Dict[str, float]]:
        return {"bytes": dict(self.bytes), "calls": dict(self.calls)}


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched under it."""

    def __init__(self):
        super().__init__()
        self.count = CollectiveCount()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if kind_of(func) is not None:
            self.count.note(func, flat_tensors(args))
        return out


def flat_tensors(tree) -> List[torch.Tensor]:
    """The tensors of nested lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in flat_tensors(x)]
    return []
