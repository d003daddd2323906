"""Decode-time full KV caches, written IN PLACE.

Cache layout mirrors the transformer's stacked layers: for each position
``j`` of the block pattern there is one entry whose tensors carry a
leading ``n_super`` axis, plus unstacked entries for tail layers:

- attn  : full cache (B, S_max, KV, D) x2; positions implied by cursor.
- swa   : ring cache (B, window, KV, D) x2 + explicit slot positions
          ``pos`` (B, window) int32, -1 for a slot never written.
- rglru : Griffin state {h: (B, d_rnn), conv: (B, 3, d_rnn)}, float32.
- rwkv  : {shift: (B, D), wkv: (B, H, hd, hd), channel: (B, D)}, float32.

Unlike ``repro.models.kvcache``, where every write returns a new pytree
(and donation lets XLA alias it), every write here updates the given
tensors in place and returns the same dict. The serving engine's slot
arena depends on that: one resident cache per (model, seq), stepped and
recycled without ever being reallocated. The transformer writes the
recurrent states back into their leaves in place as well.
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


def _walk_leaves(node, fn, names=()) -> None:
    """Call ``fn(names, leaf)`` on every tensor of a cache tree."""
    if isinstance(node, dict):
        for k, v in node.items():
            _walk_leaves(v, fn, names + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk_leaves(v, fn, names + (i,))
    elif isinstance(node, torch.Tensor):
        fn(names, node)


def cache_reset_rows(cache, rows: torch.Tensor):
    """Reset the given batch rows of a cache tree to their initial state,
    in place (a masked fill), and return the same tree.

    ``rows``: (B,) bool — True rows are wiped, False rows untouched.
    Stacked superblock leaves are (n_super, B, ...); everything else is
    batch-major. Leaves named ``pos`` reset to -1, everything else to 0.
    """
    b = rows.shape[0]

    def reset(names, x):
        axis = 1 if names and names[0] == "super" else 0
        if x.dim() <= axis or x.shape[axis] != b:
            raise ValueError(
                f"cache leaf {list(names)} has no batch axis {axis} of size {b}: "
                f"{tuple(x.shape)}"
            )
        shape = [1] * x.dim()
        shape[axis] = b
        mask = rows.to(device=x.device, dtype=torch.bool).reshape(shape)
        x.masked_fill_(mask, -1 if "pos" in names else 0)

    _walk_leaves(cache, reset)
    return cache


def ring_cache_present_window(cache, cursor: int):
    """Mark every slot of every ring cache in a cache tree as written,
    holding the positions of the tokens up to ``cursor`` that the ring
    keeps (-1 where that position would be negative), in place, and
    return the same tree. K and V are left as they are.

    A full cache's validity follows from the cursor alone, so a decode
    at cursor c attends to all c + 1 slots whatever was written; a ring's
    validity is its written positions. Decode with synthetic cursors
    (the profiler's prefix-mode steps) presents the rings this way, so
    that each swa layer does the work of a full window, as a served row
    at that cursor does.
    """

    def present(names, x):
        if names[-1] != "pos":
            return
        window = x.shape[-1]
        p = torch.arange(cursor - window + 1, cursor + 1, device=x.device)
        row = torch.full((window,), -1, dtype=x.dtype, device=x.device)
        row[p % window] = torch.where(p >= 0, p, -1).to(x.dtype)
        x.copy_(row.expand_as(x))

    _walk_leaves(cache, present)
    return cache


def attn_cache_init(
    batch: int, max_len: int, n_kv: int, head_dim: int, dtype, device="cuda",
    lead: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    """``lead`` prepends axes (``(n_super,)`` for a stacked layer entry)."""
    shape = lead + (batch, max_len, n_kv, head_dim)
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


def ring_cache_init(
    batch: int, window: int, n_kv: int, head_dim: int, dtype, device="cuda",
    lead: Tuple[int, ...] = (),
) -> Dict[str, torch.Tensor]:
    """``lead`` as in ``attn_cache_init``."""
    cache = attn_cache_init(batch, window, n_kv, head_dim, dtype, device, lead)
    cache["pos"] = torch.full(lead + (batch, window), -1, dtype=torch.int32, device=device)
    return cache


def ring_cache_write(
    cache: Dict, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor
) -> Dict:
    """k, v: (B, 1, KV, D); pos: (B,) absolute positions. Row b's token
    goes to slot ``pos[b] % window``, in place; returns ``cache``."""
    b, window = cache["pos"].shape
    idx = torch.arange(b, device=k.device)
    slot = pos.long() % window
    cache["k"][idx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][idx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][idx, slot] = pos.to(torch.int32)
    return cache


def ring_cache_views(cache: Dict, pos: torch.Tensor) -> Tuple:
    """(k, v, kv_positions, kv_valid): the slots' own positions, valid
    where a slot has been written (``pos >= 0``)."""
    kv_pos = cache["pos"]
    return cache["k"], cache["v"], kv_pos, kv_pos >= 0


def ring_cache_fill_from_prefill(
    cache: Dict, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor
) -> Dict:
    """Bulk-populate a ring from a prefill's last ``window`` tokens, in
    place. k, v: (B, S, KV, D); positions: (B, S)."""
    window = cache["pos"].shape[1]
    take = min(window, k.shape[1])
    p_tail = positions[:, -take:].long()
    slots = p_tail % window  # (B, take)
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][bidx, slots] = k[:, -take:].to(cache["k"].dtype)
    cache["v"][bidx, slots] = v[:, -take:].to(cache["v"].dtype)
    cache["pos"][bidx, slots] = p_tail.to(torch.int32)
    return cache
