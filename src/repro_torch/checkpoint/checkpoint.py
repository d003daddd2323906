"""Atomic, async checkpointing in the JAX package's on-disk format.

Layout on disk (the same as ``repro.checkpoint.checkpoint``'s, so a
checkpoint written by either package restores in the other):

    <dir>/step_00000123.tmp/...    (in-flight write)
    <dir>/step_00000123/           (atomically renamed when complete)
        manifest.json              (step; per leaf: name, file, shape, dtype)
        leaf_00000.npy ...

- **Leaf names** are ``jax.tree_util.keystr`` of each leaf's path
  (``"['decoder']['self_attn']['wq']"``, ``"['super'][0]['mixer']['wq']"``;
  a NamedTuple's fields by attribute, as ``TrainState``'s
  ``".params['embed']"``, ``".opt.step"``, ``".opt.m['embed']"``),
  computed here without JAX; leaves are numbered in JAX's flatten order
  (dict keys sorted, lists, tuples and NamedTuple fields in order).
- **bfloat16** leaves are written as the reference writes them: a raw
  ``<V2`` ``.npy`` whose manifest dtype is ``"bfloat16"``. They are read
  back from their raw bytes as ``torch.bfloat16``, with no ``ml_dtypes``.
  (The reference itself cannot restore them: ``jnp.asarray`` refuses the
  ``|V2`` array ``np.load`` returns.)
- **atomicity**: a crash mid-save leaves only a ``.tmp`` directory, which
  restore ignores and the next save garbage-collects.
- **async**: ``save`` copies every tensor to host memory on the caller's
  thread (the stall) and writes the files on a background thread;
  ``wait`` joins it and raises what it raised.
- **retention**: the ``keep`` newest checkpoints are kept.
- ``restore(step, target, device=...)`` places every leaf on ``device``,
  the port's counterpart of the reference's ``shardings``. Resharding
  waits for the port's sharding layer.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


def _walk(tree: Any, fn: Callable[[str, Any], Any], path: str = "") -> Any:
    """``tree`` rebuilt with each leaf replaced by ``fn(name, leaf)``,
    visiting leaves in JAX's flatten order; ``name`` is JAX's keystr."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _walk(tree[k], fn, f"{path}[{k!r}]")
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_walk(getattr(tree, f), fn, f"{path}.{f}") for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}[{i}]") for i, v in enumerate(tree))
    if tree is None:  # an empty subtree to JAX
        return None
    return fn(path, tree)


def leaf_paths(tree: Any) -> List[Tuple[str, Any]]:
    """[(keystr, leaf)] in JAX's flatten order."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, lambda name, leaf: out.append((name, leaf)))
    return out


def _snapshot(leaf) -> Any:
    """A host copy of one leaf that later writes to ``leaf`` cannot touch:
    a CPU tensor for a tensor (bf16 kept), else a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _save_leaf(path: str, arr) -> Tuple[List[int], str]:
    """Write one leaf as ``.npy``; returns (shape, manifest dtype)."""
    if isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16:
        raw = arr.contiguous().view(torch.int16).numpy()
        header = {"descr": "<V2", "fortran_order": False, "shape": tuple(raw.shape)}
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, header)
            f.write(raw.tobytes())
        return list(raw.shape), BF16
    if isinstance(arr, torch.Tensor):
        arr = arr.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.array(np.load(path), order="C")  # a copy; a () leaf stays ()
    if dtype == BF16:  # raw 2-byte records: reinterpret their bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # ----- save -----------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Checkpoint ``tree`` (nested dicts and lists of tensors or
        arrays) as ``step``. Returns once every leaf is copied to host
        memory; the files are written on a background thread unless
        ``blocking``."""
        self.wait()  # one in-flight save at a time
        leaves = [(name, _snapshot(leaf)) for name, leaf in leaf_paths(tree)]

        def _write():
            try:
                tmp = self._step_dir(step) + ".tmp"
                final = self._step_dir(step)
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                manifest = {"step": step, "leaves": []}
                for i, (name, arr) in enumerate(leaves):
                    fname = f"leaf_{i:05d}.npy"
                    shape, dtype = _save_leaf(os.path.join(tmp, fname), arr)
                    manifest["leaves"].append(
                        {"name": name, "file": fname, "shape": shape, "dtype": dtype})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(tmp)
                else:
                    os.replace(tmp, final)
                self._gc()
            except BaseException as e:  # surfaced by wait()
                self._error = e

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s))
        for d in os.listdir(self.directory):  # orphans of crashed saves
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    # ----- restore ----------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, device="cuda") -> Any:
        """Checkpoint ``step`` in the structure of ``target`` (a tree of
        tensors, arrays or anything with a ``shape``), every leaf a tensor
        of the checkpoint's dtype on ``device``."""
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {e["name"]: e for e in manifest["leaves"]}

        def load(name, leaf):
            entry = by_name[name]
            t = _load_leaf(os.path.join(path, entry["file"]), entry["dtype"])
            expected = tuple(leaf.shape)
            if tuple(t.shape) != expected:
                raise ValueError(
                    f"checkpoint leaf {name} shape {tuple(t.shape)} != {expected}")
            return t.to(device)

        return _walk(target, load)
