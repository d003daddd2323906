"""Recurrent sequence mixers, in PyTorch: RG-LRU (RecurrentGemma/Griffin)
and RWKV-6.

Both are linear recurrences with data-dependent, element-wise decay,
ported from ``repro.models.recurrent`` with its names, parameter specs
and layouts.

RG-LRU (arXiv:2402.19427 §2.4):
    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)  (data-dependent decay, c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
The enclosing Griffin recurrent block: dual linear branches, a width-4
causal depthwise conv on the recurrent branch, GeLU gating on the other.

RWKV-6 "Finch" (arXiv:2404.05892): token-shift with data-dependent
interpolation (LoRA adapters), per-head matrix-valued state
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w0 + lora_w(x~_t))).

``impl`` as in the port's attention: ``"xla"`` and ``"pallas"`` run the
two recurrences through ``repro_torch.kernels.ops`` (the hand-written
kernel for CUDA tensors, its plain version for CPU tensors); ``"dense"``
runs the plain scans on any device. The reference's prefill uses an
associative scan for RG-LRU under ``"xla"``; the port's plain scan is
sequential (the same function, summed in time order). Under autograd the
kernel path's gradients come from the two recurrences' backward kernels
(``kernels/wkv6_bwd.py``, ``kernels/rglru_bwd.py``); the full-sequence
forward used in training passes no ``wkv_out``, which the kernel refuses
then.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import rglru_chunked_plain, rglru_ref, wkv6_chunked_plain
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models.layers import Param
from repro_torch.models.sharding_hooks import pad_front, reshape

RGLRU_C = 8.0
CONV_WIDTH = 4
KERNEL_IMPLS = ("xla", "pallas")


def _check_impl(impl: str) -> None:
    if impl not in KERNEL_IMPLS + ("dense",):
        raise ValueError(f"unknown recurrence impl {impl!r}")


# ===========================================================================
# RG-LRU / Griffin recurrent block
# ===========================================================================


def rglru_spec(d_rnn: int) -> Dict[str, Param]:
    return {
        "w_a": Param((d_rnn, d_rnn), ("mlp", "mlp2")),
        "b_a": Param((d_rnn,), ("mlp",), init="zeros"),
        "w_x": Param((d_rnn, d_rnn), ("mlp", "mlp2")),
        "b_x": Param((d_rnn,), ("mlp",), init="zeros"),
        # Lambda parameterized so softplus(Lambda) spans useful decays.
        "lam": Param((d_rnn,), ("mlp",), init="ones"),
    }


def rglru_gates(p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(decay a_t, input contribution b_t) for x: (..., S, D), float32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"])
    # softplus without a linear cut-over (jax.nn.softplus is exact).
    lam = p["lam"].float()
    log_a = -RGLRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via log-space: 1 - exp(2 log_a)
    gate = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = gate * (i * xf)
    return a, b


def rglru_prefill(
    p: Dict, x: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain path. x: (B, S, D) -> (outputs (B, S, D), final state (B, D))."""
    a, b = rglru_gates(p, x)
    if any(kernel_ops.is_dtensor(t) for t in (a, b, h0)):
        # On a mesh: each rank's rows and channels, through the chunked
        # kernel's plain twin (S / 64 steps of eager dispatch, not S: the
        # dry run's 32768-step prefill would take hours over fake tensors).
        seq, last = {"batch": 0, "heads": 2}, {"batch": 0, "heads": 1}
        h, h_last = kernel_ops.mesh_call(rglru_chunked_plain, [a, b, h0], [seq, seq, last],
                                         [seq, last])
    else:
        h, h_last = rglru_ref(a, b, h0)
    return h.to(x.dtype), h_last


def conv1d_spec(d: int) -> Dict[str, Param]:
    return {
        "w": Param((CONV_WIDTH, d), (None, "mlp")),
        "b": Param((d,), ("mlp",), init="zeros"),
    }


def _conv_window(w: torch.Tensor, bias: torch.Tensor, hist: torch.Tensor, s: int):
    """Depthwise conv over ``hist`` (B, W-1+S, D), one output per step."""
    out = hist[:, 0:s] * w[0]
    for i in range(1, CONV_WIDTH):
        out = out + hist[:, i : i + s] * w[i]
    return out + bias


def griffin_block_spec(d_model: int, d_rnn: int) -> Dict:
    return {
        "in_x": Param((d_model, d_rnn), ("embed", "mlp")),
        "in_gate": Param((d_model, d_rnn), ("embed", "mlp")),
        "conv": conv1d_spec(d_rnn),
        "rglru": rglru_spec(d_rnn),
        "out": Param((d_rnn, d_model), ("mlp", "embed")),
    }


def griffin_block(
    p: Dict, x: torch.Tensor, state: Optional[Dict] = None, impl: str = "xla"
) -> Tuple[torch.Tensor, Dict]:
    """Griffin recurrent block, full-sequence form. x: (B, S, D).
    Returns (y, new_state): state carries (h, conv window) for decode,
    both float32. With ``state`` it continues a sequence (decode is
    S = 1)."""
    _check_impl(impl)
    branch = x @ p["in_x"]
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")
    s = branch.shape[1]
    if state is None:
        h0 = None
        hist = pad_front(branch, CONV_WIDTH - 1)
    else:
        # Continuation: convolve over the carried inputs, not zero padding.
        h0 = state["h"]
        hist = torch.cat([state["conv"].to(branch.dtype), branch], dim=1)
    conv_out = _conv_window(p["conv"]["w"], p["conv"]["b"], hist, s)
    if impl in KERNEL_IMPLS:
        a, bb = rglru_gates(p["rglru"], conv_out)
        # The kernel takes h0 itself; the reference folds it into b[:, 0]
        # (b_1 + a_1 h0), the same sum in the same rounding.
        rec, h_last = kernel_ops.rglru_scan(
            a.contiguous(), bb.contiguous(),
            None if h0 is None else h0.float().contiguous(),
        )
        rec = rec.to(x.dtype)
    else:
        rec, h_last = rglru_prefill(p["rglru"], conv_out, h0)
    y = (rec * gate) @ p["out"]
    new_state = {
        "h": h_last,
        # The TRUE last W-1 raw inputs, including carried history when the
        # chunk is shorter than the conv window (decode: S = 1).
        "conv": hist[:, -(CONV_WIDTH - 1):].float(),
    }
    return y, new_state


def griffin_init_state(
    batch: int, d_rnn: int, device="cuda", lead: Tuple[int, ...] = ()
) -> Dict:
    """The decode state ``griffin_block(state=...)`` carries, zeros.
    ``lead`` prepends axes (``(n_super,)`` for a stacked layer entry)."""
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=torch.float32, device=device)
    return {"h": zeros(batch, d_rnn), "conv": zeros(batch, CONV_WIDTH - 1, d_rnn)}


# ===========================================================================
# RWKV-6 (Finch)
# ===========================================================================

LORA_RANK = 32


def _lora(d_in: int, d_out: int) -> Dict[str, Param]:
    return {
        "a": Param((d_in, LORA_RANK), ("embed", None), scale=0.02),
        "b": Param((LORA_RANK, d_out), (None, "embed"), scale=0.02),
    }


def _apply_lora(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ p["a"]) @ p["b"]


def rwkv6_timemix_spec(d_model: int, n_heads: int) -> Dict:
    head_dim = d_model // n_heads
    return {
        "mu": Param((5, d_model), (None, "embed"), scale=0.02),  # r,k,v,g,w
        "mu_x": Param((d_model,), ("embed",), scale=0.02),
        "lora_rkvgw": _lora(d_model, 5 * d_model),
        "w_r": Param((d_model, d_model), ("embed", "heads_flat")),
        "w_k": Param((d_model, d_model), ("embed", "heads_flat")),
        "w_v": Param((d_model, d_model), ("embed", "heads_flat")),
        "w_g": Param((d_model, d_model), ("embed", "heads_flat")),
        "w_o": Param((d_model, d_model), ("heads_flat", "embed")),
        "decay_base": Param((d_model,), ("embed",), init="zeros"),
        "lora_w": _lora(d_model, d_model),
        "bonus_u": Param((n_heads, head_dim), ("heads", "head_dim"), scale=0.02),
        "ln_scale": Param((d_model,), ("embed",), init="ones"),
        "ln_bias": Param((d_model,), ("embed",), init="zeros"),
    }


def _rwkv6_inputs(p: Dict, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift interpolation (Finch ddlerp) and
    per-channel decay. x, x_prev: (B, S, D)."""
    d = x.shape[-1]
    delta = x_prev - x
    x_base = x + delta * p["mu_x"]
    mods = reshape(_apply_lora(p["lora_rkvgw"], x_base), *x.shape[:-1], 5, d)
    mix = p["mu"] + mods  # (B, S, 5, D)
    xr, xk, xv, xg, xw = [x + delta * mix[..., i, :] for i in range(5)]
    r = xr @ p["w_r"]
    k = xk @ p["w_k"]
    v = xv @ p["w_v"]
    g = F.silu(xg @ p["w_g"])
    log_neg_w = p["decay_base"] + _apply_lora(p["lora_w"], xw)
    w = torch.exp(-torch.exp(log_neg_w.float()))  # (B, S, D) in (0, 1), float32
    return r, k, v, g, w


def rwkv6_wkv_scan(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K) decay in (0, 1)
    u: torch.Tensor,  # (H, K) bonus
    state: Optional[torch.Tensor] = None,  # (B, H, K, V)
    *,
    state_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence, plain path. Returns (out float32, state');
    ``state_out`` as in ``kernels.ops.wkv6``. On a mesh it runs on each
    rank's rows and heads (``ops.mesh_call``)."""
    if any(kernel_ops.is_dtensor(t) for t in (r, k, v, w, u, state)):
        # On a mesh: each rank's rows and heads; S > 1 through the chunked
        # kernel's plain twin, as for the RG-LRU scan.
        bh, st = {"batch": 0, "heads": 2}, {"batch": 0, "heads": 1}
        scan = wkv6_plain if r.shape[1] == 1 else wkv6_chunked_plain
        out, new = kernel_ops.mesh_call(lambda *a: scan(a[0].float(), *a[1:]),
                                        [r, k, v, w, u, state],
                                        [bh] * 4 + [{"heads": 0}, st], [bh, st])
        if state_out is not None:
            state_out.copy_(new)
            new = state_out
        return out, new
    return wkv6_plain(r.float(), k, v, w, u, state, state_out=state_out)


def _keep_held(leaf: torch.Tensor, new: torch.Tensor, active: Optional[torch.Tensor]) -> None:
    """Write a recurrent state leaf in place: ``new`` on the rows
    ``active`` marks (every row when None), the old value on the rest."""
    if active is None:
        leaf.copy_(new)
    else:
        rows = active.reshape((-1,) + (1,) * (leaf.dim() - 1))
        leaf.copy_(torch.where(rows, new.to(leaf.dtype), leaf))


def rwkv6_timemix(
    p: Dict,
    x: torch.Tensor,  # (B, S, D)
    n_heads: int,
    state: Optional[Dict] = None,
    impl: str = "xla",
    wkv_out: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Time-mix. ``wkv_out`` (optional; may be ``state["wkv"]``) receives
    the new wkv state in place, as the decode arena wants it. ``active``
    (decode) marks the rows the recurrence steps: a held row's wkv state
    stays as it was (the kernel skips it; the plain path writes
    ``wkv_out`` through ``_keep_held``)."""
    _check_impl(impl)
    b, s, d = x.shape
    hd = d // n_heads
    if state is None:
        x_prev = pad_front(x, 1)[:, :-1]
        wkv_state = None
    else:
        x_prev = torch.cat([state["shift"][:, None, :].to(x.dtype), x[:, :-1]], dim=1)
        wkv_state = state["wkv"]
    r, k, v, g, w = _rwkv6_inputs(p, x, x_prev)
    rh = reshape(r, b, s, n_heads, hd)
    kh = reshape(k, b, s, n_heads, hd)
    vh = reshape(v, b, s, n_heads, hd)
    wh = reshape(w, b, s, n_heads, hd)
    if impl in KERNEL_IMPLS:
        out, wkv_new = kernel_ops.wkv6(
            rh.contiguous(), kh.contiguous(), vh.contiguous(), wh.contiguous(),
            p["bonus_u"].contiguous(), wkv_state, state_out=wkv_out, active=active,
        )
    else:
        out, wkv_new = rwkv6_wkv_scan(rh, kh, vh, wh, p["bonus_u"], wkv_state)
        if wkv_out is not None:
            _keep_held(wkv_out, wkv_new, active)
            wkv_new = wkv_out
    # Per-head group norm (float32), then gate and output projection.
    oh = out.float()
    mu = oh.mean(dim=-1, keepdim=True)
    var = oh.var(dim=-1, keepdim=True, unbiased=False)
    oh = (oh - mu) * torch.rsqrt(var + 1e-5)
    out = reshape(oh, b, s, d) * p["ln_scale"] + p["ln_bias"]
    y = (out.to(x.dtype) * g) @ p["w_o"]
    # States are kept float32 across steps (cache dtype stability).
    return y, {"shift": x[:, -1].float(), "wkv": wkv_new}


def rwkv6_channelmix_spec(d_model: int, d_ff: int) -> Dict:
    return {
        "mu_k": Param((d_model,), ("embed",), scale=0.02),
        "mu_r": Param((d_model,), ("embed",), scale=0.02),
        "w_k": Param((d_model, d_ff), ("embed", "mlp")),
        "w_v": Param((d_ff, d_model), ("mlp", "embed")),
        "w_r": Param((d_model, d_model), ("embed", "embed2")),
    }


def rwkv6_channelmix(
    p: Dict, x: torch.Tensor, state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """state: (B, D) last token (None = zero-shift prefill)."""
    if state is None:
        x_prev = pad_front(x, 1)[:, :-1]
    else:
        x_prev = torch.cat([state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    delta = x_prev - x
    xk = x + delta * p["mu_k"]
    xr = x + delta * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["w_k"]))
    out = torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"])
    return out, x[:, -1].float()


def rwkv6_init_state(
    batch: int, d_model: int, n_heads: int, device="cuda", lead: Tuple[int, ...] = ()
) -> Dict:
    """An rwkv layer's decode state, zeros, flat as the decode arena keeps
    it: time-mix ``shift`` and ``wkv``, channel-mix ``channel``. (The
    reference nests the first two under ``time``.) ``lead`` as in
    ``griffin_init_state``."""
    hd = d_model // n_heads
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=torch.float32, device=device)
    return {
        "shift": zeros(batch, d_model),
        "wkv": zeros(batch, n_heads, hd, hd),
        "channel": zeros(batch, d_model),
    }
