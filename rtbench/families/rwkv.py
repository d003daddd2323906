"""An RWKV-6 block (rwkv6-1.6b as the port defines it).

Weights (``leaves``): the port's tree, fan-in scaled matrices, 0.02 for
the embedding and the small leaves; norm weights, biases and the decay
base drawn too (the port starts them at 0 or 1), so that a program that
dropped one would disagree with the reference.

Reference (``trunk``): layer norm eps 1e-5; time-mix with data-dependent
token shift through a rank-32 adapter, decay ``exp(-exp(base +
adapter))``, the WKV recurrence ``o_t = r_t (S + diag(u) k_t^T v_t)``,
``S <- diag(w_t) S + k_t^T v_t`` stepped in time order, per-head
normalisation (eps 1e-5), SiLU gate; channel-mix with squared ReLU and a
sigmoid receptance; the final layer norm.

Operations a token and layer: 2 a multiply-add of its matrix weights
(``block_matmul_params``) and 7 K V a head for the recurrence.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from rtbench.reference.models import Convert, layer_norm, layer_of, to_float32

LORA_RANK = 32  # the port's token-shift and decay adapters


def leaves(d: Dict) -> List[Tuple[Tuple, Tuple[int, ...], float, float]]:
    """[(path, shape, std, mean)] for the config numbers ``d``."""
    L, D, H, F_, V = d["n_layers"], d["d_model"], d["n_heads"], d["d_ff"], d["vocab_size"]
    hd = d.get("head_dim") or D // H
    blk, m = ("super", 0), ("mixer",)
    return [
        (("embed",), (V, D), 0.02, 0.0),
        (blk + ("norm1", "scale"), (L, D), 0.1, 1.0),
        (blk + ("norm1", "bias"), (L, D), 0.1, 0.0),
        (blk + m + ("mu",), (L, 5, D), 0.02, 0.0),
        (blk + m + ("mu_x",), (L, D), 0.02, 0.0),
        (blk + m + ("lora_rkvgw", "a"), (L, D, LORA_RANK), 0.02, 0.0),
        (blk + m + ("lora_rkvgw", "b"), (L, LORA_RANK, 5 * D), 0.02, 0.0),
        (blk + m + ("w_r",), (L, D, D), 1 / math.sqrt(D), 0.0),
        (blk + m + ("w_k",), (L, D, D), 1 / math.sqrt(D), 0.0),
        (blk + m + ("w_v",), (L, D, D), 1 / math.sqrt(D), 0.0),
        (blk + m + ("w_g",), (L, D, D), 1 / math.sqrt(D), 0.0),
        (blk + m + ("w_o",), (L, D, D), 1 / math.sqrt(D), 0.0),
        # Decays exp(-exp(x)) from about 0.99 (x = -4.6) to 0.07 (x = 1).
        (blk + m + ("decay_base",), (L, D), 1.0, -2.0),
        (blk + m + ("lora_w", "a"), (L, D, LORA_RANK), 0.02, 0.0),
        (blk + m + ("lora_w", "b"), (L, LORA_RANK, D), 0.02, 0.0),
        (blk + m + ("bonus_u",), (L, H, hd), 0.02, 0.0),
        (blk + m + ("ln_scale",), (L, D), 0.1, 1.0),
        (blk + m + ("ln_bias",), (L, D), 0.1, 0.0),
        (blk + ("norm2", "scale"), (L, D), 0.1, 1.0),
        (blk + ("norm2", "bias"), (L, D), 0.1, 0.0),
        (blk + ("ffn", "mu_k"), (L, D), 0.02, 0.0),
        (blk + ("ffn", "mu_r"), (L, D), 0.02, 0.0),
        (blk + ("ffn", "w_k"), (L, D, F_), 1 / math.sqrt(D), 0.0),
        (blk + ("ffn", "w_v"), (L, F_, D), 1 / math.sqrt(F_), 0.0),
        (blk + ("ffn", "w_r"), (L, D, D), 1 / math.sqrt(D), 0.0),
        (("final_norm", "scale"), (D,), 0.1, 1.0),
        (("final_norm", "bias"), (D,), 0.1, 0.0),
    ]


def shift(x):
    """Each position's predecessor (zeros before the first)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv_scan(r, k, v, w, u):
    """r, k, w: (B, S, H, K); v: (B, S, H, V); u: (H, K). Stepped in time order."""
    b, s, h, dk = r.shape
    st = torch.zeros(b, h, dk, v.shape[-1], dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], st + u[None, :, :, None] * kv))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(outs, dim=1)


def time_mix(p, x, dims):
    b, s, d = x.shape
    h = dims["n_heads"]
    hd = d // h
    delta = shift(x) - x
    base = x + delta * p["mu_x"]
    mods = (torch.tanh(base @ p["lora_rkvgw"]["a"]) @ p["lora_rkvgw"]["b"]).reshape(b, s, 5, d)
    mix = p["mu"] + mods
    xr, xk, xv, xg, xw = (x + delta * mix[:, :, i] for i in range(5))
    r, k, v = xr @ p["w_r"], xk @ p["w_k"], xv @ p["w_v"]
    g = F.silu(xg @ p["w_g"])
    w = torch.exp(-torch.exp(p["decay_base"] + torch.tanh(xw @ p["lora_w"]["a"]) @ p["lora_w"]["b"]))
    split = lambda t: t.reshape(b, s, h, hd)
    o = wkv_scan(split(r), split(k), split(v), split(w), p["bonus_u"])
    mu = o.mean(-1, keepdim=True)
    var = (o - mu).square().mean(-1, keepdim=True)
    o = ((o - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d) * p["ln_scale"] + p["ln_bias"]
    return (o * g) @ p["w_o"]


def channel_mix(p, x):
    delta = shift(x) - x
    k = torch.relu((x + delta * p["mu_k"]) @ p["w_k"]).square()
    return torch.sigmoid((x + delta * p["mu_r"]) @ p["w_r"]) * (k @ p["w_v"])


def trunk(tree, tokens, dims, convert: Convert = to_float32):
    """Final normalised hidden states (B, S, D) of ``tokens`` (B, S)."""
    x = convert(tree["embed"])[tokens]
    for i in range(dims["n_layers"]):
        p = layer_of(tree, i, convert)
        x = x + time_mix(p["mixer"], layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]), dims)
        x = x + channel_mix(p["ffn"], layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"]))
    fn = tree["final_norm"]
    return layer_norm(x, convert(fn["scale"]), convert(fn["bias"]))


def block_matmul_params(d: Dict) -> int:
    """Weights a token multiplies through in one block."""
    D, F_ = d["d_model"], d["d_ff"]
    lora = D * LORA_RANK + LORA_RANK * 5 * D + D * LORA_RANK + LORA_RANK * D
    return 5 * D * D + lora + 2 * D * F_ + D * D


def mixer_flops(d: Dict, ctx: int) -> float:
    """The WKV recurrence of one token in one layer (any context)."""
    hd = d.get("head_dim") or d["d_model"] // d["n_heads"]
    return float(7 * d["n_heads"] * hd * hd)
