"""A Granite-4.0-H hybrid block family (granite-4.0-h-micro as published).

Layers come in periods of ten: five Mamba-2 layers, one attention layer,
four Mamba-2 layers (``PATTERN``); every layer has a SwiGLU MLP. The
Mamba-2 sizes, the period and Granite's multipliers are the published
config's and live here as module constants, since the harness hands a
family eight numbers (``n_layers``, ``d_model``, heads, ``d_ff``,
vocabulary): the inner width is ``EXPAND * d_model`` in heads of
``SSM_HEAD_DIM`` with a state of ``SSM_STATE`` (one group of B and C).

Weights (``leaves``): the port's tree (``super``: one stacked entry per
position of the period), fan-in scaled matrices; norm weights, conv
bias, ``dt_bias`` (mean -3: steps of about 0.05), ``a_log`` (mean 1: A
about -2.7) and the D skip drawn too, so that a program that dropped one
would disagree with the reference. The embedding's scale is 0.005
(``EMBED_STD``), not the dense family's 0.02: times the published
embedding multiplier of 12, and tied to the head, 0.02 makes each
position's own token the argmax of its logits in 16 of 16 prompts and
99% of positions (measured on an H100 at full width), so that the check
would compare echoes, which the float8 control gets right too; at 0.005
no position of that probe echoed.

Reference (``trunk``), plain float32 with TF32 off, following
``GraniteMoeHybridForCausalLM`` (transformers 4.57): the embedding times
12; per layer, RMS norm (weight ``1 + scale``, eps 1e-5), the mixer, the
residual ``x + 0.22 * mixer``, RMS norm, SwiGLU, ``x + 0.22 * mlp``. The
attention layer: grouped-query, no positional embedding (NoPE), causal,
scores scaled by 0.015625. The Mamba-2 mixer: ``[z | xBC | dt] = h W_in``,
a causal depthwise conv of width 4 with bias and SiLU over xBC, which
splits into x (heads of 64), B and C (128); ``dt = softplus(dt +
dt_bias)``, ``A = -exp(a_log)``; the recurrence stepped token by token,
``S_t = exp(dt A) S_{t-1} + dt x_t (x) B_t``, ``y_t = S_t C_t + D x_t``;
then ``RMSNorm(y * SiLU(z))`` over the whole inner width and ``W_out``.
The final RMS norm's output is divided by ``logits_scaling`` (8), which
the shared tied head (``reference/models.py``) then turns into the
published logits, the head being linear.

Operations a token and layer, averaged over the period so that
``n_layers`` of them count the 36 + 4 layers: 2 a multiply-add of the
matrix weights (``block_matmul_params``), and (``mixer_flops``) 5 H P N a
Mamba-2 layer for the recurrence (its state update and S C), 4 H D a
(query, key) pair the attention layer.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from rtbench.reference.models import Convert, rms_norm, to_float32

PATTERN = ("mamba2",) * 5 + ("attn",) + ("mamba2",) * 4
EXPAND = 2  # mamba_expand
SSM_HEAD_DIM = 64  # mamba_d_head
SSM_STATE = 128  # mamba_d_state (one group: mamba_n_groups 1)
CONV = 4  # mamba_d_conv
EMBEDDING_MULTIPLIER = 12.0
RESIDUAL_MULTIPLIER = 0.22
ATTENTION_MULTIPLIER = 0.015625
LOGITS_SCALING = 8.0
EPS = 1e-5  # rms_norm_eps
EMBED_STD = 0.005  # see the module's docstring


def _ssm(d: Dict) -> Tuple[int, int, int]:
    """(heads, inner width, conv channels) at the config numbers ``d``."""
    inner = EXPAND * d["d_model"]
    return inner // SSM_HEAD_DIM, inner, inner + 2 * SSM_STATE


def leaves(d: Dict) -> List[Tuple[Tuple, Tuple[int, ...], float, float]]:
    """[(path, shape, std, mean)] for the config numbers ``d``."""
    D, H, F_, V = d["d_model"], d["n_heads"], d["d_ff"], d["vocab_size"]
    if d["n_layers"] % len(PATTERN):
        raise ValueError(f"{d['n_layers']} layers is no whole number of periods of "
                         f"{len(PATTERN)}")
    L = d["n_layers"] // len(PATTERN)
    hd = d.get("head_dim") or D // H
    kv = d["n_kv_heads"]
    sh, inner, cd = _ssm(d)
    out = [(("embed",), (V, D), EMBED_STD, 0.0)]
    for j, kind in enumerate(PATTERN):
        blk, m = ("super", j), ("super", j, "mixer")
        out.append((blk + ("norm1", "scale"), (L, D), 0.1, 0.0))
        if kind == "attn":
            out += [
                (m + ("wq",), (L, D, H, hd), 1 / math.sqrt(D), 0.0),
                (m + ("wk",), (L, D, kv, hd), 1 / math.sqrt(D), 0.0),
                (m + ("wv",), (L, D, kv, hd), 1 / math.sqrt(D), 0.0),
                (m + ("wo",), (L, H, hd, D), 1 / math.sqrt(H * hd), 0.0),
            ]
        else:
            out += [
                (m + ("in_proj",), (L, D, inner + cd + sh), 1 / math.sqrt(D), 0.0),
                (m + ("conv_w",), (L, CONV, cd), 1 / math.sqrt(CONV), 0.0),
                (m + ("conv_b",), (L, cd), 0.1, 0.0),
                (m + ("dt_bias",), (L, sh), 1.0, -3.0),
                (m + ("a_log",), (L, sh), 0.5, 1.0),
                (m + ("d_skip",), (L, sh), 0.1, 1.0),
                (m + ("norm",), (L, inner), 0.1, 0.0),
                (m + ("out_proj",), (L, inner, D), 1 / math.sqrt(inner), 0.0),
            ]
        out += [
            (blk + ("norm2", "scale"), (L, D), 0.1, 0.0),
            (blk + ("ffn", "gate"), (L, D, F_), 1 / math.sqrt(D), 0.0),
            (blk + ("ffn", "up"), (L, D, F_), 1 / math.sqrt(D), 0.0),
            (blk + ("ffn", "down"), (L, F_, D), 1 / math.sqrt(F_), 0.0),
        ]
    out.append((("final_norm", "scale"), (D,), 0.1, 0.0))
    return out


def _layer(tree, i: int, convert: Convert) -> Tuple[str, Dict]:
    """Layer ``i``'s kind and leaves, converted."""
    j, s = i % len(PATTERN), i // len(PATTERN)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return convert(node[s])
    return PATTERN[j], walk(tree["super"][j])


def attention(p, x, dims):
    """Causal grouped-query attention without positions, scores scaled by
    ``ATTENTION_MULTIPLIER``."""
    b, s, d = x.shape
    h, kv = dims["n_heads"], dims["n_kv_heads"]
    hd = dims.get("head_dim") or d // h
    q = (x @ p["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    k = (x @ p["wk"].reshape(d, kv * hd)).reshape(b, s, kv, hd)
    v = (x @ p["wv"].reshape(d, kv * hd)).reshape(b, s, kv, hd)
    g = h // kv
    k = k.repeat_interleave(g, dim=2)  # query head j reads kv head j // g
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * ATTENTION_MULTIPLIER
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return o.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, d)


def mamba2(p, x, dims):
    """The Mamba-2 mixer, its recurrence stepped token by token."""
    b, s, _ = x.shape
    sh, inner, cd = _ssm(dims)
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = zxbcdt[..., :inner], zxbcdt[..., inner:inner + cd], zxbcdt[..., inner + cd:]
    hist = F.pad(xbc, (0, 0, CONV - 1, 0))
    conv = sum(hist[:, k:k + s] * p["conv_w"][k] for k in range(CONV)) + p["conv_b"]
    u = F.silu(conv)
    xs = u[..., :inner].reshape(b, s, sh, SSM_HEAD_DIM)
    bm, cm = u[..., inner:inner + SSM_STATE], u[..., inner + SSM_STATE:]
    step = F.softplus(dt + p["dt_bias"])  # (B, S, H)
    rate = -torch.exp(p["a_log"])  # (H,)
    st = torch.zeros(b, sh, SSM_HEAD_DIM, SSM_STATE, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dtt = step[:, t]
        st = (torch.exp(dtt * rate)[:, :, None, None] * st
              + (dtt[:, :, None] * xs[:, t])[..., None] * bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", st, cm[:, t]) + p["d_skip"][:, None] * xs[:, t])
    y = torch.stack(ys, dim=1).reshape(b, s, inner)
    return rms_norm(y * F.silu(z), p["norm"], EPS) @ p["out_proj"]


def trunk(tree, tokens, dims, convert: Convert = to_float32):
    """The final normalised hidden states (B, S, D) of ``tokens`` (B, S),
    over ``LOGITS_SCALING``."""
    x = convert(tree["embed"])[tokens] * EMBEDDING_MULTIPLIER
    for i in range(dims["n_layers"]):
        kind, p = _layer(tree, i, convert)
        h = rms_norm(x, p["norm1"]["scale"], EPS)
        y = attention(p["mixer"], h, dims) if kind == "attn" else mamba2(p["mixer"], h, dims)
        x = x + RESIDUAL_MULTIPLIER * y
        h = rms_norm(x, p["norm2"]["scale"], EPS)
        f = p["ffn"]
        x = x + RESIDUAL_MULTIPLIER * ((F.silu(h @ f["gate"]) * (h @ f["up"])) @ f["down"])
    return rms_norm(x, convert(tree["final_norm"]["scale"]), EPS) / LOGITS_SCALING


def block_matmul_params(d: Dict) -> float:
    """Weights a token multiplies through in one block, the period's mean."""
    D, H, F_ = d["d_model"], d["n_heads"], d["d_ff"]
    hd = d.get("head_dim") or D // H
    sh, inner, cd = _ssm(d)
    attn = D * H * hd * 2 + 2 * D * d["n_kv_heads"] * hd
    ssm = D * (inner + cd + sh) + inner * D
    per = [attn if k == "attn" else ssm for k in PATTERN]
    return sum(per) / len(PATTERN) + 3 * D * F_


def mixer_flops(d: Dict, ctx: int) -> float:
    """The mixer of one token at context ``ctx`` in one layer, the
    period's mean: 5 H P N a Mamba-2 layer, 4 H D ctx the attention one."""
    hd = d.get("head_dim") or d["d_model"] // d["n_heads"]
    sh, _, _ = _ssm(d)
    per = [4 * d["n_heads"] * hd * ctx if k == "attn" else 5 * sh * SSM_HEAD_DIM * SSM_STATE
           for k in PATTERN]
    return float(sum(per) / len(PATTERN))
