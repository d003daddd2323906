"""A dense decoder block (granite-3-2b as the port defines it).

Weights (``leaves``): the port's tree, fan-in scaled matrices, 0.02 for
the embedding; norm weights drawn too (the port starts them at 0), so
that a program that dropped one would disagree with the reference.

Reference (``trunk``): RMS norm with weight ``1 + scale`` (eps 1e-6),
rotary embeddings on q and k (theta from the config, halves rotated),
causal grouped-query attention, SwiGLU FFN, the final RMS norm.

Operations a token and layer: 2 a multiply-add of its matrix weights
(``block_matmul_params``) and 4 H D a (query, key) pair.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from rtbench.reference.models import Convert, layer_of, rms_norm, to_float32


def leaves(d: Dict) -> List[Tuple[Tuple, Tuple[int, ...], float, float]]:
    """[(path, shape, std, mean)] for the config numbers ``d``."""
    L, D, H, F_, V = d["n_layers"], d["d_model"], d["n_heads"], d["d_ff"], d["vocab_size"]
    hd = d.get("head_dim") or D // H
    kv = d["n_kv_heads"]
    blk = ("super", 0)
    return [
        (("embed",), (V, D), 0.02, 0.0),
        (blk + ("norm1", "scale"), (L, D), 0.1, 0.0),
        (blk + ("mixer", "wq"), (L, D, H, hd), 1 / math.sqrt(D), 0.0),
        (blk + ("mixer", "wk"), (L, D, kv, hd), 1 / math.sqrt(D), 0.0),
        (blk + ("mixer", "wv"), (L, D, kv, hd), 1 / math.sqrt(D), 0.0),
        (blk + ("mixer", "wo"), (L, H, hd, D), 1 / math.sqrt(H * hd), 0.0),
        (blk + ("norm2", "scale"), (L, D), 0.1, 0.0),
        (blk + ("ffn", "gate"), (L, D, F_), 1 / math.sqrt(D), 0.0),
        (blk + ("ffn", "up"), (L, D, F_), 1 / math.sqrt(D), 0.0),
        (blk + ("ffn", "down"), (L, F_, D), 1 / math.sqrt(F_), 0.0),
        (("final_norm", "scale"), (D,), 0.1, 0.0),
    ]


def rope(x, theta):
    """x: (B, S, H, D) at positions 0..S-1; the two halves rotated."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[None, :, None, :], torch.cos(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention_block(p, x, dims):
    b, s, d = x.shape
    h, kv = dims["n_heads"], dims["n_kv_heads"]
    hd = dims.get("head_dim") or d // h
    q = (x @ p["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    k = (x @ p["wk"].reshape(d, kv * hd)).reshape(b, s, kv, hd)
    v = (x @ p["wv"].reshape(d, kv * hd)).reshape(b, s, kv, hd)
    q, k = rope(q, dims["rope_theta"]), rope(k, dims["rope_theta"])
    g = h // kv
    k = k.repeat_interleave(g, dim=2)  # query head j reads kv head j // g
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return o.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, d)


def trunk(tree, tokens, dims, convert: Convert = to_float32):
    """Final normalised hidden states (B, S, D) of ``tokens`` (B, S)."""
    x = convert(tree["embed"])[tokens]
    for i in range(dims["n_layers"]):
        p = layer_of(tree, i, convert)
        x = x + attention_block(p["mixer"], rms_norm(x, p["norm1"]["scale"]), dims)
        h = rms_norm(x, p["norm2"]["scale"])
        f = p["ffn"]
        x = x + (F.silu(h @ f["gate"]) * (h @ f["up"])) @ f["down"]
    return rms_norm(x, convert(tree["final_norm"]["scale"]))


def block_matmul_params(d: Dict) -> int:
    """Weights a token multiplies through in one block."""
    D, H, F_ = d["d_model"], d["n_heads"], d["d_ff"]
    hd = d.get("head_dim") or D // H
    return D * H * hd * 2 + 2 * D * d["n_kv_heads"] * hd + 3 * D * F_


def mixer_flops(d: Dict, ctx: int) -> float:
    """Attention of one token at context ``ctx`` in one layer."""
    hd = d.get("head_dim") or d["d_model"] // d["n_heads"]
    return float(4 * d["n_heads"] * hd * ctx)
