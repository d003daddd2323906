"""FLOP and HBM-byte counting by watching the ops a call dispatches: the
port's counterpart of ``repro.roofline.jaxpr_cost`` (which walks a
jaxpr), with the collective counts of ``comm_cost`` in the same pass.

``OpCost`` is a ``TorchDispatchMode``. Run the call under it, eagerly, on
real or fake tensors, plain or DTensor:

- **FLOPs** use ``torch.utils.flop_counter``'s per-op formulas (its
  ``flop_registry``: matmuls, convolutions, fused attention), the
  2·B·M·N·K convention of the reference; elementwise and reduction FLOPs
  are ignored, as there. ``FlopCounterMode`` itself is not the counter:
  under DTensor it sees both the global op and each rank's local op, and
  adds the two.
- **Bytes** follow ``jaxpr_cost.py``'s ideal-fusion traffic rule
  (``_TRAFFIC_PRIMS``): operand + result bytes of matmuls and
  data-movement ops (embedding, gather/scatter, index, slice scatter,
  sort, cumsum) only, everything elementwise assumed fused.
- **Attention internals are left out**, as ``_is_attention_internal``
  leaves them out: the logits, probabilities and float32 accumulators of
  the dense attention path, which live on chip in the kernels. The
  reference tells them by rank (rank >= 5 float32, its dot_general
  operands). Here ``einsum`` reaches dispatch as ``bmm`` on rank-3
  copies, so the rule follows storage instead: a float32 storage that an
  op other than a copy or a layout change (``_LAYOUT``) ever presents at
  rank >= 5 is internal, and no traffic on it counts. The port's dense
  attention upcasts q, k and v to float32 before its products; those
  copies are what its matmuls read, so a bf16 model's attention operands
  count at 4 bytes an element where the reference's count 2.
- **Loops.** Eager code runs every layer, so L layers count L times one
  layer and remat's recomputation counts in the backward; there is no
  trip count to multiply.
- **Global against per-rank.** Two dispatch modes watch one run. The
  outer one sees what the program issues, an op on DTensors at its
  global shapes (the logical program, the reference's jaxpr count). The
  inner one passes DTensor ops on to DTensor and sees the local ops it
  then runs on this rank's shards, with the collectives between them:
  this rank's own work (the reference's per-device HLO dots, which
  charge replicated compute to every rank). A plain op counts in both.
  Sharding propagation's shape runs count in neither. Code that runs on
  one rank's shard of an evenly split computation outside DTensor
  (``sharding.local_region``: the kernels' and dense attention's
  shard_map view, MoE's local path) is seen by both views as plain ops;
  the outer one charges it once per shard.

``flops_of(fn, *args)`` and ``costs_of(fn, *args)`` are the reference's
entry points: global FLOPs, and (global FLOPs, global ideal bytes).
"""
from __future__ import annotations

import math
import sys
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import local_shards
from repro_torch.roofline import comm_cost

aten = torch.ops.aten

_TRAFFIC = {
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
    aten.convolution_backward, aten.embedding, aten.embedding_dense_backward,
    aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_, aten.gather,
    aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_, aten.index_copy,
    aten.index_copy_, aten.index_add, aten.index_add_, aten.index_select, aten.sort,
    aten.cumsum, aten.slice_scatter, aten.select_scatter,
}
# Copies and layout changes: presenting a storage at rank >= 5 through one
# of these (einsum's decomposition does) does not make it internal.
_LAYOUT = {
    aten._to_copy, aten.clone, aten.unsqueeze, aten.squeeze, aten.permute,
    aten.transpose, aten.t, aten.expand, aten._unsafe_view, aten.alias, aten.detach,
    aten.slice, aten.select, aten.unbind, aten.split, aten.split_with_sizes, aten.copy_,
}


def _dtensor_cls():
    from torch.distributed.tensor import DTensor

    return DTensor


def _in_sharding_propagation() -> bool:
    """Whether the current op is DTensor's shape run of a global op (its
    sharding propagation), not work of this rank."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("tensor/_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def tensor_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape) * t.element_size()


class _Tally:
    """One scope's counts: FLOPs and traffic events."""

    def __init__(self, shared):
        self.shared = shared  # the OpCost: storage keys and the internal set
        self.flops = 0.0
        self.events: List[Tuple[Any, int]] = []  # (storage key, bytes)
        self.all_bytes = 0.0  # every op's operands + results

    def note(self, func, args, kwargs, out, weight: int = 1) -> None:
        """Count one op; ``weight`` > 1 for one shard of an even split
        (``sharding.local_region``), which the global program runs on
        every shard."""
        packet = func.overloadpacket
        ins, outs = comm_cost.flat_tensors((args, kwargs)), comm_cost.flat_tensors(out)
        if packet in flop_registry:
            self.flops += weight * float(flop_registry[packet](*args, **kwargs, out_val=out))
        if packet not in _LAYOUT:
            for t in outs:
                if t.dim() >= 5 and t.dtype == torch.float32:
                    self.shared.internal.add(self.shared.key(t))
        if packet in _TRAFFIC:
            self.events.extend((self.shared.key(t), weight * tensor_bytes(t))
                               for t in ins + outs)
        self.all_bytes += weight * sum(tensor_bytes(t) for t in ins + outs)

    def bytes(self) -> float:
        internal = self.shared.internal
        return float(sum(b for k, b in self.events if k not in internal))


class _GlobalView(TorchDispatchMode):
    """The outer mode: every op the program issues, DTensor ops at their
    global shapes. DTensor's own work runs inside its handler, unseen."""

    def __init__(self, tally: _Tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.tally.note(func, args, kwargs, out, weight=local_shards())
        return out


class _LocalView(TorchDispatchMode):
    """The inner mode: what runs on this rank. It passes DTensor ops on to
    DTensor and then sees their local ops and collectives; plain ops it
    sees directly."""

    def __init__(self, tally: _Tally, comm: comm_cost.CollectiveCount):
        super().__init__()
        self.tally, self.comm = tally, comm

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor_cls()) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if comm_cost.kind_of(func) is not None:
            self.comm.note(func, comm_cost.flat_tensors(args))
        elif not _in_sharding_propagation():
            self.tally.note(func, args, kwargs, out)
        return out


class OpCost:
    """Counts FLOPs, ideal traffic bytes and collectives of what runs under
    it (see the module's docstring): a context manager that stacks the
    local view under the global one. Read ``result()`` after the block."""

    def __init__(self):
        self.internal: set = set()
        self._keep: List[Any] = []  # storages, so no key is reused while counting
        self.global_ = _Tally(self)
        self.local = _Tally(self)
        self.comm = comm_cost.CollectiveCount()
        self._modes = [_LocalView(self.local, self.comm), _GlobalView(self.global_)]

    def key(self, t: torch.Tensor):
        if isinstance(t, _dtensor_cls()):
            t = t._local_tensor
        s = t.untyped_storage()
        self._keep.append(s)
        return s._cdata

    def __enter__(self):
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        self._keep.clear()
        return False

    def result(self) -> Dict[str, Any]:
        return {
            "flops_global": self.global_.flops,
            "flops_local": self.local.flops,
            "bytes_global": self.global_.bytes(),
            "bytes_local": self.local.bytes(),
            "bytes_local_all_ops": self.local.all_bytes,
            "collectives": self.comm.result(),
        }


def run_counted(fn, *args) -> Tuple[Any, Dict[str, Any]]:
    """(fn(*args), the counts of that call)."""
    with OpCost() as oc:
        out = fn(*args)
    return out, oc.result()


def flops_of(fn, *args) -> float:
    return run_counted(fn, *args)[1]["flops_global"]


def costs_of(fn, *args) -> Tuple[float, float]:
    """(flops, ideal_bytes), global: one run, both counts."""
    r = run_counted(fn, *args)[1]
    return r["flops_global"], r["bytes_global"]
