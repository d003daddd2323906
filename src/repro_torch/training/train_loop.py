"""The train step: loss -> gradients -> AdamW (``repro.training.train_loop``
in the port).

``make_train_step(model, tcfg)`` returns ``train_step(state, batch) ->
(state', metrics)``. Parameters are leaves with ``requires_grad``; the
gradients come from ``torch.autograd.grad`` through the model's loss
(on the card: the hand-written flash attention kernels, forward and
backward, with per-layer remat when ``cfg.remat`` is set), and the AdamW
update is applied in place under ``torch.no_grad()``. A leaf that no
gradient reaches raises (autograd's own check), so no gradient is lost
silently.

``batch`` is ``{"tokens": (B, S)}`` (+ ``"positions"`` (3, B, S) for
M-RoPE archs), or ``{"frames", "dec_tokens"}`` for encoder-decoder
archs, as tensors on the parameters' device. With ``grad_accum = k`` the
batch is split into k micro-batches along the batch axis (the positions'
axis 1) as the reference splits it; losses and float32 gradients are
summed over them in order and divided by k.

Sharding: ``shardings_for_state`` derives every leaf's layout from the
model's logical-axes tree through the rules engine (the step replicated,
m and v laid out like their parameters), ``batch_sharding`` a batch
array's, and ``place_state`` / ``place_batch`` lay tensors out as
DTensors on a mesh. The same step then runs on the placed state: under
``sharding.mesh_mode`` plain tensors (positions, masks, scalars) count
as replicated, each gradient is redistributed to its parameter's layout
(the reduce-scatter of FSDP) before the update, and the gradient norm is
taken over the sharded leaves. The same functions serve real training
(``launch/train.py`` on the host mesh) and the dry run
(``launch/dryrun.py``, over fake tensors on a fake group).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import map_tree, tree_leaves
from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.AdamWState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    grad_accum: int = 1
    aux_weight: float = 0.01


def trainable(params: Any) -> Any:
    """``params`` with every leaf a leaf tensor that requires a gradient
    (in place)."""
    return map_tree(lambda t: t.requires_grad_(), params)


def init_state(model, generator: torch.Generator, dtype=None, device="cuda") -> TrainState:
    """Parameters drawn from ``generator`` on ``device``, made trainable,
    and a zero AdamW state beside them."""
    params = trainable(model.init(generator, dtype, device=device))
    return TrainState(params=params, opt=opt.init(params))


def abstract_state(model, dtype=None) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device."""
    params = model.abstract_params(dtype)
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return TrainState(params=params, opt=opt.AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        m=map_tree(f32, params), v=map_tree(f32, params)))


def state_axes(model) -> TrainState:
    axes = model.axes()
    return TrainState(params=axes, opt=opt.AdamWState(step=(), m=axes, v=axes))


def shardings_for_state(model, mesh) -> TrainState:
    """A NamedSharding per state leaf: parameters by ``PARAM_RULES``, m
    and v laid out like their parameters, the step replicated."""
    axes = state_axes(model)
    shapes = abstract_state(model)
    leaf = lambda t, ax: shd.NamedSharding(
        mesh, shd.spec_for_shape(t.shape, ax, mesh, shd.PARAM_RULES))
    return TrainState(
        params=shd.map_axes(leaf, shapes.params, axes.params),
        opt=opt.AdamWState(
            step=shd.NamedSharding(mesh, ()),
            m=shd.map_axes(leaf, shapes.opt.m, axes.opt.m),
            v=shd.map_axes(leaf, shapes.opt.v, axes.opt.v)))


def batch_sharding(mesh, shape: Tuple[int, ...], axes: Optional[Tuple] = None):
    """Sharding for a data-batch array: batch over (pod, data)."""
    if axes is None:
        axes = ("batch",) + ("seq",) * (len(shape) - 1)
    return shd.NamedSharding(mesh, shd.spec_for_shape(shape, axes, mesh, shd.ACT_RULES))


def _zip_state(fn, state: TrainState, shardings: TrainState) -> TrainState:
    def tree(t, s):
        if isinstance(t, dict):
            return {k: tree(t[k], s[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return [tree(a, b) for a, b in zip(t, s)]
        return fn(t, s)

    return TrainState(params=tree(state.params, shardings.params), opt=opt.AdamWState(
        step=fn(state.opt.step, shardings.opt.step),
        m=tree(state.opt.m, shardings.opt.m), v=tree(state.opt.v, shardings.opt.v)))


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """``state`` (full tensors, the same on every rank) as DTensors laid
    out by ``shardings``; parameters stay trainable."""
    return _zip_state(shd.place, state, shardings)


def full_state(state: TrainState) -> TrainState:
    """Every leaf as its full tensor (what a checkpoint writes)."""
    return _zip_state(lambda t, _: shd.full(t), state, state)


def place_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """A batch laid out by ``batch_sharding`` (M-RoPE positions keep their
    batch axis at 1)."""
    out = {}
    for name, x in batch.items():
        axes = (None, "batch", "seq") if name == "positions" else None
        if name == "frames":
            axes = ("batch", "seq", "embed")
        out[name] = shd.place(x, batch_sharding(mesh, tuple(x.shape), axes))
    return out


def _micro(batch: Dict[str, torch.Tensor], k: int, i: int) -> Dict[str, torch.Tensor]:
    """Micro-batch ``i`` of ``k``: rows [i B/k, (i+1) B/k) of every entry
    (the positions' batch axis is 1)."""
    out = {}
    for name, x in batch.items():
        if name == "positions":
            out[name] = x.reshape(x.shape[0], k, -1, *x.shape[2:])[:, i]
        else:
            out[name] = x.reshape(k, -1, *x.shape[1:])[i]
    return out


def make_train_step(
    model, tcfg: TrainConfig
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, Any]]]:
    def loss_fn(params, micro):
        if "frames" in micro:
            return model.loss(params, micro["frames"], micro["dec_tokens"])
        return model.loss(params, micro["tokens"], micro.get("positions"),
                          aux_weight=tcfg.aux_weight)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = tree_leaves(state.params)
        meshed = any(shd.is_dtensor(t) for t in leaves)
        with shd.mesh_mode() if meshed else contextlib.nullcontext():
            return _step(state, batch, leaves, meshed)

    def _step(state: TrainState, batch, leaves, meshed) -> Tuple[TrainState, Dict[str, Any]]:
        k = tcfg.grad_accum
        with torch.enable_grad():
            if k <= 1:
                loss = loss_fn(state.params, batch)
                grads = list(torch.autograd.grad(loss, leaves))
                loss = loss.detach()
            else:
                loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
                for i in range(k):
                    lo = loss_fn(state.params, _micro(batch, k, i))
                    for tot, g in zip(grads, torch.autograd.grad(lo, leaves)):
                        tot.add_(g.float())
                    loss = loss + lo.detach()
                loss = loss / k
                grads = [g / k for g in grads]
        if meshed:
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if tuple(g.placements) != tuple(p.placements) else g
                     for g, p in zip(grads, leaves)]
        it = iter(grads)
        grad_tree = map_tree(lambda _: next(it), state.params)
        with torch.no_grad():
            params, new_opt, metrics = opt.update(tcfg.adamw, grad_tree, state.opt,
                                                  state.params)
        metrics["loss"] = loss
        if meshed:  # every rank reads the same full scalars
            metrics = {name: shd.full(v) for name, v in metrics.items()}
        return TrainState(params=params, opt=new_opt), metrics

    return train_step

