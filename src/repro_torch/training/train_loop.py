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

Not here yet: ``abstract_state``, ``state_axes``, ``shardings_for_state``
and ``batch_sharding`` wait for the port's sharding slice (ROADMAP.md
§A), as does the cross-pod compressed reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

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
        k = tcfg.grad_accum
        with torch.enable_grad():
            if k <= 1:
                loss = loss_fn(state.params, batch)
                grads = list(torch.autograd.grad(loss, leaves))
                loss = loss.detach()
            else:
                loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for p in leaves]
                for i in range(k):
                    lo = loss_fn(state.params, _micro(batch, k, i))
                    for tot, g in zip(grads, torch.autograd.grad(lo, leaves)):
                        tot.add_(g.float())
                    loss = loss + lo.detach()
                loss = loss / k
                grads = [g / k for g in grads]
        it = iter(grads)
        grad_tree = map_tree(lambda _: next(it), state.params)
        with torch.no_grad():
            params, new_opt, metrics = opt.update(tcfg.adamw, grad_tree, state.opt,
                                                  state.params)
        metrics["loss"] = loss
        return TrainState(params=params, opt=new_opt), metrics

    return train_step
