"""Parameter conversion between the JAX package's trees and the port's.

``params_from_numpy(cfg, tree)`` takes the parameter tree that
``repro``'s ``model.init(key)`` returns, with every leaf already turned
into a numpy array by the caller (this module never imports JAX), and
returns the port's tree: the same nested dicts and lists, the same
stacked superblock leaves with their leading ``n_super`` axis, as
tensors. numpy has no bfloat16 of its own (JAX's bf16 leaves arrive as
an extension dtype named ``bfloat16``), so those leaves travel through
float32 — exact, since every bf16 value is a float32 value — and are
cast back. ``params_to_numpy`` goes the other way, bf16 leaves coming
back as float32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Param, map_tree
from repro_torch.models.transformer import model_spec


def _leaf_to_tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def _zip_check(spec: Any, tree: Any, path: str = "params") -> None:
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(spec) != set(tree):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path}: expected keys {sorted(spec)}, got {got}")
        for k in spec:
            _zip_check(spec[k], tree[k], f"{path}[{k!r}]")
    elif isinstance(spec, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(spec) != len(tree):
            raise ValueError(f"{path}: expected a list of {len(spec)}")
        for i, (s, t) in enumerate(zip(spec, tree)):
            _zip_check(s, t, f"{path}[{i}]")
    elif isinstance(spec, Param):
        shape = tuple(np.shape(tree))
        if shape != tuple(spec.shape):
            raise ValueError(f"{path}: expected shape {spec.shape}, got {shape}")


def params_from_numpy(cfg: ModelConfig, tree: Any, device="cuda") -> Any:
    """The JAX parameter tree (numpy leaves) as the port's tensor tree,
    checked leaf by leaf against the port's spec for ``cfg``."""
    _zip_check(model_spec(cfg), tree)
    return map_tree(lambda a: _leaf_to_tensor(a, device), tree)


def params_to_numpy(params: Any) -> Any:
    """The port's tensor tree as numpy arrays (bf16 leaves as float32)."""

    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return map_tree(conv, params)
