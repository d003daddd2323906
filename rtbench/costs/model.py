"""Model operations of one served step, counting real work only.

A decode step counts its active rows (one token each, at context
``ctx``); a prefill counts its real rows (the bucket's padding rows are
not model work), every token of each through the blocks and the head on
the last position, as the port's prefill runs it. Matrix products count
2 operations a multiply-add. ``family`` is the model's block family (a
module of ``families/``), which gives its weights a token multiplies
through (``block_matmul_params``) and its mixer's operations at a
context (``mixer_flops``).
"""
from typing import Dict, Sequence


def token_flops(family, d: Dict, ctx: int) -> float:
    """One token through every block at context ``ctx`` (its position + 1)."""
    per_layer = 2 * family.block_matmul_params(d) + family.mixer_flops(d, ctx)
    return float(d["n_layers"] * per_layer)


def head_flops(d: Dict) -> float:
    return float(2 * d["d_model"] * d["vocab_size"])


def decode_step_flops(family, d: Dict, ctx: Sequence[int]) -> float:
    return sum(token_flops(family, d, c) + head_flops(d) for c in ctx)


def prefill_flops(family, d: Dict, rows: int, length: int) -> float:
    per_row = sum(token_flops(family, d, c) for c in range(1, length + 1)) + head_flops(d)
    return rows * per_row
