"""The port's CheckpointManager against the JAX package's: the same
on-disk format, so a checkpoint written by either package restores in the
other, on the CPU.

Leaf names are ``jax.tree_util.keystr`` of each leaf's path; bf16 leaves
are raw ``<V2`` ``.npy`` files with manifest dtype ``bfloat16``. The port
reads those back from their raw bytes. The reference cannot restore its
own bf16 checkpoints (``test_reference_cannot_restore_bf16`` records it);
it restores float32 ones.
"""
import filecmp
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.registry import tiny as jtiny
from repro.models import model_for as jmodel_for
from repro_torch import interop
from repro_torch.checkpoint.checkpoint import CheckpointManager, leaf_paths
from repro_torch.configs.registry import tiny

KEY = jax.random.PRNGKey(11)
ARCHS = ["whisper-large-v3", "granite-3-2b", "qwen2-vl-72b"]


def _jax_params(arch, dtype="float32"):
    return jmodel_for(jtiny(arch, param_dtype=dtype)).init(KEY)


def _port_params(arch, jp, dtype="float32"):
    return interop.params_from_numpy(tiny(arch, param_dtype=dtype),
                                     jax.tree.map(np.asarray, jp), device="cpu")


def _abstract(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_names_are_jax_keystrs_in_flatten_order(arch):
    jp = _jax_params(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = [jax.tree_util.keystr(kp) for kp, _ in flat]
    got = [name for name, _ in leaf_paths(_port_params(arch, jp))]
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_written_float32_restores_in_port(tmp_path, arch):
    jp = _jax_params(arch)
    JaxCheckpointManager(str(tmp_path)).save(3, jp, blocking=True)
    target = _port_params(arch, jax.tree.map(jnp.zeros_like, jp))
    out = CheckpointManager(str(tmp_path)).restore(3, target, device="cpu")
    flat = dict(leaf_paths(out))
    for name, leaf in leaf_paths(jax.tree.map(np.asarray, jp)):
        assert flat[name].dtype == torch.float32
        np.testing.assert_array_equal(flat[name].numpy(), leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_written_float32_restores_in_jax(tmp_path, arch):
    jp = _jax_params(arch)
    tp = _port_params(arch, jp)
    CheckpointManager(str(tmp_path)).save(4, tp, blocking=True)
    out = JaxCheckpointManager(str(tmp_path)).restore(4, _abstract(jp))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree_util.tree_leaves_with_path(out)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_files_are_byte_identical(tmp_path, arch):
    """The same tree written by both packages gives the same manifest and
    the same bytes in every leaf file, bf16 included."""
    for dtype in ("float32", "bfloat16"):
        jp = _jax_params(arch, dtype)
        JaxCheckpointManager(str(tmp_path / f"jax_{dtype}")).save(1, jp, blocking=True)
        CheckpointManager(str(tmp_path / f"port_{dtype}")).save(
            1, _port_params(arch, jp, dtype), blocking=True)
        a, b = (tmp_path / f"{w}_{dtype}" / "step_00000001" for w in ("jax", "port"))
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b))
        _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
        assert mismatch == [] and errors == []


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_written_bf16_restores_in_port_bit_for_bit(tmp_path, arch):
    jp = _jax_params(arch, "bfloat16")
    JaxCheckpointManager(str(tmp_path)).save(7, jp, blocking=True)
    assert {e["dtype"] for e in _manifest(tmp_path, 7)["leaves"]} == {"bfloat16"}
    target = _port_params(arch, jp, "bfloat16")
    out = CheckpointManager(str(tmp_path)).restore(7, target, device="cpu")
    flat = dict(leaf_paths(out))
    for name, leaf in leaf_paths(jp):
        got = flat[name]
        assert got.dtype == torch.bfloat16
        bits = np.asarray(leaf).view(np.uint16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), bits)


def test_reference_cannot_restore_bf16(tmp_path):
    """Recorded reference behaviour: its restore hands ``np.load``'s ``|V2``
    array to ``jnp.asarray``, which refuses it. (Its own tests restore
    float32 trees only.) The port restores the same checkpoint."""
    tree = {"w": jnp.arange(4, dtype=jnp.bfloat16)}
    mgr = JaxCheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=True)
    with pytest.raises(TypeError):
        mgr.restore(1, _abstract(tree))
    out = CheckpointManager(str(tmp_path)).restore(1, {"w": torch.zeros(4)}, device="cpu")
    assert out["w"].equal(torch.arange(4, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# twins of tests/test_training_substrate.py::TestCheckpoint
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)},
            "l": [torch.zeros(2, dtype=torch.bfloat16), np.arange(3, dtype=np.int32)]}
    mgr.save(10, tree, blocking=True)
    assert mgr.latest_step() == 10
    out = mgr.restore(10, tree, device="cpu")
    assert out["a"].equal(tree["a"]) and out["b"]["c"].equal(tree["b"]["c"])
    assert out["l"][0].dtype == torch.bfloat16 and out["l"][1].tolist() == [0, 1, 2]
    assert list(out) == list(tree)


def test_async_save_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(8)}
    for s in [1, 2, 3, 4]:
        mgr.save(s, tree)
    mgr.wait()
    mgr._gc()
    assert mgr.all_steps() == [3, 4]


def test_save_snapshots_before_returning(tmp_path):
    """An async save copies every leaf before it returns: a later in-place
    update of the tensor does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.zeros(1000)
    mgr.save(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    assert float(mgr.restore(1, {"w": w}, device="cpu")["w"].abs().max()) == 0.0


def test_crash_leaves_no_partial_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert mgr.latest_step() is None
    mgr.save(5, {"w": torch.zeros(2)}, blocking=True)
    assert mgr.latest_step() == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)}, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore(1, {"w": torch.zeros(5)}, device="cpu")


def test_write_errors_surface_in_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_00000001.tmp").write_text("")  # a file where the write needs a directory
    mgr.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once
    assert mgr.latest_step() is None


def test_restore_defaults_to_the_card():
    assert inspect.signature(CheckpointManager.restore).parameters["device"].default == "cuda"
