"""Decode-time full KV caches, written IN PLACE.

Cache layout mirrors the transformer's stacked layers: for each position
``j`` of the block pattern there is one entry whose tensors carry a
leading ``n_super`` axis, plus unstacked entries for tail layers:

- attn : full cache (B, S_max, KV, D) x2; positions implied by cursor.

Unlike ``repro.models.kvcache``, where every write returns a new pytree
(and donation lets XLA alias it), every write here updates the given
tensors in place and returns the same dict. The serving engine's slot
arena depends on that: one resident cache per (model, seq), stepped and
recycled without ever being reallocated. Ring caches (``swa``) and
recurrent states are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import tree_leaves


def cache_nbytes(cache) -> int:
    """Total on-device bytes of a cache tree (resident-memory metrics)."""
    return sum(
        t.numel() * t.element_size()
        for t in tree_leaves(cache)
        if isinstance(t, torch.Tensor)
    )


def cache_reset_rows(cache, rows: torch.Tensor):
    """Reset the given batch rows of a cache tree to their initial state,
    in place (a masked fill), and return the same tree.

    ``rows``: (B,) bool — True rows are wiped, False rows untouched.
    Stacked superblock leaves are (n_super, B, ...); everything else is
    batch-major. Leaves named ``pos`` reset to -1, everything else to 0.
    """
    b = rows.shape[0]

    def reset(names, x):
        if not isinstance(x, torch.Tensor):
            return
        axis = 1 if names and names[0] == "super" else 0
        if x.dim() <= axis or x.shape[axis] != b:
            raise ValueError(
                f"cache leaf {names} has no batch axis {axis} of size {b}: "
                f"{tuple(x.shape)}"
            )
        shape = [1] * x.dim()
        shape[axis] = b
        mask = rows.to(device=x.device, dtype=torch.bool).reshape(shape)
        x.masked_fill_(mask, -1 if "pos" in names else 0)

    def walk(names, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(names + [k], v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(names + [i], v)
        else:
            reset(names, node)

    walk([], cache)
    return cache


def attn_cache_init(
    batch: int, max_len: int, n_kv: int, head_dim: int, dtype, device="cuda"
) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, n_kv, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attn_cache_write(
    cache: Dict, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor
) -> Dict:
    """k, v: (B, 1, KV, D); pos: (B,) absolute positions (cursor). Writes
    row b's slot pos[b] in place for every row; returns ``cache``."""
    idx = torch.arange(k.shape[0], device=k.device)
    pos = pos.long()
    cache["k"][idx, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][idx, pos] = v[:, 0].to(cache["v"].dtype)
    return cache


def attn_cache_views(cache: Dict, pos: torch.Tensor) -> Tuple:
    """(k, v, kv_positions, kv_valid) for full caches. pos: (B,) cursor =
    position of the newest token (already written). Positions are an
    int32 arange and validity ``kv_pos <= pos``, both contiguous (B, S)."""
    b, s = cache["k"].shape[:2]
    kv_pos = (
        torch.arange(s, dtype=torch.int32, device=pos.device)
        .expand(b, s)
        .contiguous()
    )
    valid = kv_pos <= pos[:, None]
    return cache["k"], cache["v"], kv_pos, valid
