"""Logical-axis sharding rules engine (``repro.distributed.sharding`` in
the port).

Every parameter/cache/activation dim carries a *logical* axis name
(assigned in the model zoo's Param specs and ``constrain`` calls). This
module maps logical axes to mesh axes with an ordered-candidate,
divisibility-aware assignment:

  for each array dim, in order:
      for each candidate mesh axis of its logical name, in order:
          accept if (a) the axis is unused so far in this array and
                    (b) the dim size divides by the accumulated product

One rule set serves all ten architectures and all four input shapes
(GQA kv_heads that do not divide the model axis fall through to
head_dim; mixtral's 8 experts fall through to d_ff inside each expert;
a batch of 1 falls through to sequence sharding of the KV cache).

A spec is a tuple with one entry per dim, as the reference's
``PartitionSpec``: a mesh-axis name, a tuple of names, or ``None``,
trailing ``None``s trimmed. ``to_placements`` turns a spec into DTensor
placements (``Shard(d)`` / ``Replicate()`` per mesh dim).

Meshes are ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and sizes), or ``AbstractMesh``, names and sizes
alone, which needs no process group (the counterpart of
``jax.sharding.AbstractMesh``).

**Order of a dim sharded over several mesh axes (a departure).** The
reference's tuple entries are ordered by the rules:
``CACHE_RULES["seq"] = ["data", "pod"]`` on the (pod, data, model) mesh
gives ``("data", "pod")``, data-major. ``to_placements`` gives plain
``Shard`` placements, which DTensor lays out in mesh-dim order,
pod-major. Every rank's shard shape and byte count are the same either
way; which rank holds which slice is not (``shard_offset`` says which).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

LogicalAxes = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]

# Candidate mesh axes per logical axis, in priority order.
PARAM_RULES: Dict[Optional[str], List[str]] = {
    "layer": [],
    "embed": ["data", "pod"],  # FSDP / ZeRO-3 style weight sharding
    "embed2": [],
    "vocab": ["model"],
    "heads": ["model"],
    "kv_heads": ["model"],
    "head_dim": ["model"],
    "mlp": ["model"],
    "mlp2": [],
    "expert": ["model"],
    "heads_flat": ["model"],
    "capacity": [],
    None: [],
}

ACT_RULES: Dict[Optional[str], List[str]] = {
    "batch": ["pod", "data"],
    "seq": [],
    "embed": [],
    "expert": ["model"],
    "heads": ["model"],
    "capacity": [],
    None: [],
}

CACHE_RULES: Dict[Optional[str], List[str]] = {
    "layer": [],
    "batch": ["pod", "data"],
    "seq": ["data", "pod"],  # context parallelism when batch can't shard
    "kv_heads": ["model"],
    "head_dim": ["model"],
    "heads": ["model"],
    "embed": ["model"],
    None: [],
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis sizes and names without devices or a process group."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh-dim order, for either kind of mesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def spec_for_shape(
    shape: Sequence[int],
    axes: LogicalAxes,
    mesh,
    rules: Dict[Optional[str], List[str]],
) -> Spec:
    """Assign mesh axes to dims (ordered candidates + divisibility)."""
    sizes = mesh_shape(mesh)
    used: set = set()
    out: List[Any] = []
    for dim, name in zip(shape, axes):
        chosen: List[str] = []
        prod = 1
        for cand in rules.get(name, []):
            if cand in used or cand not in sizes:
                continue
            if dim % (prod * sizes[cand]) == 0:
                chosen.append(cand)
                used.add(cand)
                prod *= sizes[cand]
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(tuple(chosen))
    while out and out[-1] is None:  # canonical form, as PartitionSpec
        out.pop()
    return tuple(out)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec``: ``Shard(d)`` on every mesh dim that
    shards tensor dim d, ``Replicate()`` on the rest (mesh-dim order; see
    the module's note on order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """Every rank's shard shape under ``spec`` (the rules only shard a dim
    by a product that divides it)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[d] //= sizes[a]
    return tuple(out)


def shard_offset(shape: Sequence[int], spec: Spec, mesh, coord: Dict[str, int],
                 order: str = "port") -> Tuple[int, ...]:
    """Global offset of the shard held by the rank at mesh coordinate
    ``coord`` ({axis: index}). ``order="port"`` is DTensor's mesh-dim
    order (what this module's placements give), ``"reference"`` the
    spec entry's own order (the reference's)."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = []
    for d, n in enumerate(shape):
        entry = _entry_axes(spec[d]) if d < len(spec) else ()
        if order == "port":
            entry = tuple(sorted(entry, key=names.index))
        index = 0
        for a in entry:  # major to minor
            index = index * sizes[a] + coord[a]
        out.append(index * (n // math.prod(sizes[a] for a in entry)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, self.mesh)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def map_axes(fn: Callable[[Any, LogicalAxes], Any], tree: Any, axes_tree: Any) -> Any:
    """``fn(leaf, axes)`` over a tree of dicts and lists and the matching
    tree of logical-axes tuples."""
    if is_axes_leaf(axes_tree):
        return fn(tree, axes_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, tree[k], axes_tree[k]) for k in axes_tree}
    return [map_axes(fn, t, a) for t, a in zip(tree, axes_tree)]


def tree_shardings(
    shape_tree: Any,
    axes_tree: Any,
    mesh,
    rules: Optional[Dict[Optional[str], List[str]]] = None,
) -> Any:
    """NamedSharding tree for a tree of tensors (any device, ``meta``
    included) given the matching tree of logical-axes tuples."""
    rules = PARAM_RULES if rules is None else rules
    return map_axes(
        lambda leaf, axes: NamedSharding(mesh, spec_for_shape(leaf.shape, axes, mesh, rules)),
        shape_tree, axes_tree)


# Cache trees don't carry Param specs; derive logical axes from shapes by
# kind (see models/kvcache.py layouts).
def cache_axes(cfg, stacked: bool) -> Dict[str, LogicalAxes]:
    lead: LogicalAxes = ("layer",) if stacked else ()
    return {
        "k": lead + ("batch", "seq", "kv_heads", "head_dim"),
        "v": lead + ("batch", "seq", "kv_heads", "head_dim"),
        "pos": lead + ("batch", "seq"),
        "h": lead + ("batch", "mlp"),
        "conv": lead + ("batch", None, "mlp"),
        "shift": lead + ("batch", "embed"),
        "wkv": lead + ("batch", "heads", None, None),
        "channel": lead + ("batch", "embed"),
        "ssm": lead + ("batch", "heads", None, None),
        "self_k": lead + ("batch", "seq", "kv_heads", "head_dim"),
        "self_v": lead + ("batch", "seq", "kv_heads", "head_dim"),
        "cross_k": lead + ("batch", "seq", "kv_heads", "head_dim"),
        "cross_v": lead + ("batch", "seq", "kv_heads", "head_dim"),
    }


def cache_tree_axes(cache_tree: Any, cfg) -> Any:
    """The logical-axes tree of a decode cache (dict of lists of dicts, or
    the encoder-decoder's flat layer-stacked dict)."""

    def walk(node, stacked):
        if isinstance(node, dict) and any(k in node for k in ("k", "h", "shift", "ssm", "self_k")):
            table = cache_axes(cfg, stacked)
            return {name: table[name][: len(leaf.shape)] for name, leaf in node.items()}
        if isinstance(node, dict):
            return {k: walk(v, stacked) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, stacked) for v in node]
        raise TypeError(type(node))

    if "self_k" in cache_tree:
        return walk(cache_tree, stacked=True)
    return {key: walk(sub, stacked=(key == "super")) for key, sub in cache_tree.items()}


def cache_shardings(cache_tree: Any, cfg, mesh) -> Any:
    """Shardings for a decode cache tree."""
    return tree_shardings(cache_tree, cache_tree_axes(cache_tree, cfg), mesh, CACHE_RULES)


@contextlib.contextmanager
def rule_overrides(param=None, act=None, cache=None):
    """Temporarily override logical-axis rule entries: the mechanism
    behind the dry run's named variants. Example:
    ``rule_overrides(act={"seq": ["model"]})`` turns on sequence
    parallelism for activations."""
    saved = []
    for rules, upd in ((PARAM_RULES, param), (ACT_RULES, act), (CACHE_RULES, cache)):
        if not upd:
            continue
        for k, v in upd.items():
            saved.append((rules, k, rules.get(k, None), k in rules))
            rules[k] = v
    try:
        yield
    finally:
        for rules, k, old, existed in reversed(saved):
            if existed:
                rules[k] = old
            else:
                rules.pop(k, None)


# ---------------------------------------------------------------------------
# Placing tensors
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def place(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``t`` (the full tensor, the same on every rank) as a DTensor laid
    out by ``sharding``; ``t`` keeps ``requires_grad``."""
    from torch.distributed.tensor import distribute_tensor

    out = distribute_tensor(t.detach(), sharding.mesh, sharding.placements)
    return out.requires_grad_(t.requires_grad)


def full(t: torch.Tensor) -> torch.Tensor:
    """The full tensor of a DTensor (gathered on every rank); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def redistribute(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """``x`` (a DTensor) laid out by ``spec``; unchanged when it already is."""
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


# ---------------------------------------------------------------------------
# Local regions (the shard_map view)
# ---------------------------------------------------------------------------

_LOCAL_REGIONS: List[int] = []


@contextlib.contextmanager
def local_region(n_shards: int):
    """Code in this block runs on one rank's shard of a computation split
    evenly over ``n_shards`` ranks (plain ops on local tensors). The op
    counter (``roofline.op_cost``) charges the global program
    ``n_shards`` times what it sees here."""
    _LOCAL_REGIONS.append(n_shards)
    try:
        yield
    finally:
        _LOCAL_REGIONS.pop()


def local_shards() -> int:
    """How many even shards the current code is one of (1 outside any
    local region)."""
    return math.prod(_LOCAL_REGIONS)


def _matmul_ready(x):
    """A DTensor activation (rank >= 3) gathered on its middle dims (the
    ones a matrix product flattens into its rows after the first, where a
    shard would become a strided one no DTensor product takes)."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x) or x.dim() < 3:
        return x
    want = [Replicate() if not pl.is_replicate() and not pl.is_partial() and (
        type(pl) is not Shard or 0 < pl.dim < x.dim() - 1) else pl for pl in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _settled(x):
    """A product's pending sums (a sharded contraction) reduced at once: an
    elementwise op between a pending sum and a shard has no plan in DTensor
    (it would need the shard turned into a pending sum)."""
    from torch.distributed.tensor import Replicate

    if not any(pl.is_partial() for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if pl.is_partial() else pl for pl in x.placements])


class _GradReady(torch.autograd.Function):
    """The identity on a product's output, whose gradient is made ready the
    same way before the product's backward flattens it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _matmul_ready(grad)


def _matmul_mode():
    from torch.overrides import TorchFunctionMode

    matmuls = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}

    class MatmulInputs(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in matmuls and args and is_dtensor(args[0]) and args[0].dim() >= 3:
                out = _settled(func(_matmul_ready(args[0]), *args[1:], **(kwargs or {})))
                return _GradReady.apply(out) if out.requires_grad else out
            return func(*args, **(kwargs or {}))

    return MatmulInputs()


@contextlib.contextmanager
def mesh_mode():
    """Run model code on DTensors: plain tensors beside them count as
    replicated (``implicit_replication``), and a matrix product's
    activation is first gathered on any middle-dim shard DTensor's
    op-by-op layouts gave it (a pending sum it settles by scattering the
    sequence, for one), and so is the product's gradient in the backward;
    its pending sums are reduced at once."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import sharding_hooks

    saved = sharding_hooks._REMAT_CONTEXT
    sharding_hooks.set_remat_context(mesh_mode)  # remat's recompute, in the backward
    try:
        with implicit_replication(), _matmul_mode():
            yield
    finally:
        sharding_hooks.set_remat_context(saved)


def install_activation_resolver(mesh) -> None:
    """Route ``models.sharding_hooks.constrain`` through this mesh: a
    DTensor activation is redistributed to the layout ``ACT_RULES`` gives
    it; a plain tensor passes through unchanged."""
    from repro_torch.models import sharding_hooks

    def resolver(x, axes):
        if not is_dtensor(x):
            return x
        return redistribute(x, mesh, spec_for_shape(x.shape, axes, mesh, ACT_RULES))

    sharding_hooks.set_resolver(resolver)


def clear_activation_resolver() -> None:
    from repro_torch.models import sharding_hooks

    sharding_hooks.clear_resolver()
