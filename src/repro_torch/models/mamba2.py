"""The Mamba-2 mixer (granite-4.0-h-micro's state-space layers), in PyTorch.

Port-only: the JAX package has no such block. It follows
``GraniteMoeHybridMambaLayer.torch_forward`` (transformers 4.57), per
token t and head h:

    [z | xBC | dt] = x W_in                  (widths H P, H P + 2 G N, H)
    xBC = SiLU(causal depthwise conv1d(xBC, width 4) + conv bias)
        -> x (H heads of P), B (G N), C (G N); head h reads group h // (H / G)
    dt = softplus(dt + dt_bias), A = -exp(a_log)
    S_t[h] = exp(dt_h A_h) S_{t-1}[h] + dt_h x_t[h] (x) B_t    (P x N, float32)
    y_t[h] = S_t[h] C_t + D_h x_t[h]
    out = RMSNorm(y * SiLU(z); eps, over all H P, weight 1 + norm) W_out

The enclosing block (``transformer.py``) adds the pre-norm, Granite's
residual multiplier and the SwiGLU MLP. Parameters: ``in_proj`` (D, H P +
H P + 2 G N + H) with its three parts in that order, ``conv_w`` (W, conv
channels), ``conv_b``, ``dt_bias``, ``a_log``, ``d_skip`` (H,), ``norm``
(H P,) and ``out_proj`` (H P, D).

Decode state per row (``mamba2_init_state``): ``ssm`` (H, P, N) and
``conv`` (W - 1, conv channels), both float32. ``impl`` ``"xla"`` /
``"pallas"`` run the conv and the recurrence through ``kernels/ops``
(``ssd_chunk`` for a sequence from a zero state, ``ssd_step`` for one
decode token; CUDA tensors launch the kernels, CPU tensors their plain
twins), and the output norm through the row-norm kernel's gated form;
``"dense"`` runs the conv as eager ops, ``ref.ssd_chunked_plain`` /
``ref.ssd_step_plain`` and the plain norm chain. B and C are one group,
shared by every head (granite-4.0-h's ``mamba_n_groups`` 1), as the
kernels take them.
Decode steps only the rows ``active`` marks: a held row's states are left
as they were.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import ssd_chunked_plain, ssd_step_plain
from repro_torch.models.layers import Param, rmsnorm
from repro_torch.models.recurrent import KERNEL_IMPLS, _check_impl, _conv_window
from repro_torch.models.sharding_hooks import pad_front, reshape

CONV_WIDTH = 4  # the kernels' and ``recurrent._conv_window``'s


def mamba2_spec(cfg) -> Dict[str, Param]:
    d, di, cd, h = cfg.d_model, cfg.ssm_inner, cfg.ssm_conv_dim, cfg.ssm_heads
    return {
        "in_proj": Param((d, di + cd + h), ("embed", "mlp")),
        "conv_w": Param((CONV_WIDTH, cd), (None, "mlp")),
        "conv_b": Param((cd,), ("mlp",), init="zeros"),
        "dt_bias": Param((h,), ("heads",), init="zeros"),
        "a_log": Param((h,), ("heads",), init="zeros"),
        "d_skip": Param((h,), ("heads",), init="ones"),
        "norm": Param((di,), ("mlp",), init="zeros"),
        "out_proj": Param((di, d), ("mlp", "embed")),
    }


def mamba2_init_state(batch: int, cfg, device="cuda", lead: Tuple[int, ...] = ()) -> Dict:
    """A Mamba-2 layer's decode state, zeros: ``ssm`` (B, H, P, N) and
    ``conv`` (B, W - 1, conv channels), float32. ``lead`` prepends axes
    (``(n_super,)`` for a stacked layer entry)."""
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=torch.float32, device=device)
    return {
        "ssm": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv": zeros(batch, CONV_WIDTH - 1, cfg.ssm_conv_dim),
    }


def _split(cfg, zxbcdt: torch.Tensor):
    di, cd = cfg.ssm_inner, cfg.ssm_conv_dim
    return zxbcdt[..., :di], zxbcdt[..., di:di + cd], zxbcdt[..., di + cd:]


def _heads(cfg, u: torch.Tensor):
    """(..., conv channels) -> x (..., H, P), B and C (..., 1, N), views."""
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    lead = u.shape[:-1]
    x = reshape(u[..., : h * p], *lead, h, p)
    b = reshape(u[..., h * p: h * p + n], *lead, 1, n)
    c = reshape(u[..., h * p + n:], *lead, 1, n)
    return x, b, c


def _out(cfg, p: Dict, y: torch.Tensor, z: torch.Tensor, impl: str, eps: float) -> torch.Tensor:
    """The gated RMS norm over the inner width, then the output projection."""
    yn = rmsnorm(y, p["norm"], eps, impl=impl, gate=z)
    return yn @ p["out_proj"]


def mamba2_block(
    cfg, p: Dict, x: torch.Tensor, impl: str = "xla", eps: float = 1e-6,
    last_state: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """The mixer over a full sequence x (B, S, D) from a zero state.
    Returns (y, new_state): the state after the last token (``ssm``,
    ``conv``), float32, for the decode cache; ``last_state=False`` lets the
    kernel skip writing ``ssm`` (None then)."""
    _check_impl(impl)
    bsz, s, _ = x.shape
    z, xbc, dt = _split(cfg, x @ p["in_proj"])
    hist = pad_front(xbc, CONV_WIDTH - 1)
    if impl in KERNEL_IMPLS:
        # The kernel takes the conv and SiLU itself: its output never
        # reaches memory.
        y, last = kernel_ops.ssd_chunk(xbc, p["conv_w"], p["conv_b"], dt, p["dt_bias"],
                                       p["a_log"], p["d_skip"], state_size=cfg.ssm_state,
                                       last_state=last_state)
    else:
        u = F.silu(_conv_window(p["conv_w"], p["conv_b"], hist, s))
        xs, bm, cm = _heads(cfg, u)
        y, last = ssd_chunked_plain(xs, dt, p["dt_bias"], p["a_log"], bm, cm, p["d_skip"])
        y = y.to(x.dtype)
    y = _out(cfg, p, reshape(y, bsz, s, cfg.ssm_inner), z, impl, eps)
    return y, {"ssm": last, "conv": hist[:, -(CONV_WIDTH - 1):].float()}


def mamba2_decode(
    cfg, p: Dict, x: torch.Tensor, cache: Dict, active: Optional[torch.Tensor],
    impl: str = "xla", eps: float = 1e-6,
) -> torch.Tensor:
    """One token x (B, 1, D) through the mixer against ``cache`` (``ssm``,
    ``conv``), updated IN PLACE on the ``active`` rows (every row when
    None); a held row's states are untouched."""
    _check_impl(impl)
    bsz = x.shape[0]
    z, xbc, dt = _split(cfg, (x @ p["in_proj"])[:, 0])
    args = (xbc, dt, cache["conv"], p["conv_w"], p["conv_b"], p["dt_bias"], p["a_log"],
            p["d_skip"], cache["ssm"], active)
    y = kernel_ops.ssd_step(*args) if impl in KERNEL_IMPLS else ssd_step_plain(*args)
    return _out(cfg, p, y.reshape(bsz, 1, cfg.ssm_inner), z[:, None], impl, eps)
