"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``).

For each of the ten configs at full size (specs only: shapes on the
``meta`` device and JAX ShapeDtypeStructs, nothing allocated), every
parameter leaf's spec and every decode-cache leaf's spec equal the
reference's, on (1, 1), (16, 16) and (2, 16, 16) abstract meshes and
under every named rule variant of the dry run (``OPT_RULES``, read from
the reference's source, whose import would set ``XLA_FLAGS``). Then the
twins of ``tests/test_training_substrate.py::TestShardingRules``, the
train-state and batch shardings, the order in which a dim sharded over
two mesh axes lays out its shards (the port's departure, pinned on a
fake process group), and the resolver as the identity outside a mesh.
"""
import ast
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import registry as ref_registry
from repro.distributed import sharding as ref_shd
from repro.models import model_for as ref_model_for
from repro.training import train_loop as ref_train_loop
from repro_torch.configs import registry
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import model_for, sharding_hooks
from repro_torch.training import train_loop

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(registry.ARCHS)
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _ref_opt_rules():
    """``OPT_RULES`` as the reference's dry run writes it (its source,
    parsed; importing the module would set XLA_FLAGS for this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        target = getattr(node, "target", None) or (node.targets[0] if isinstance(
            node, ast.Assign) else None)
        if isinstance(target, ast.Name) and target.id == "OPT_RULES":
            return ast.literal_eval(node.value)
    raise AssertionError("OPT_RULES not found in the reference's dry run")


REF_OPT_RULES = _ref_opt_rules()


def _meshes(name):
    sizes, names = MESHES[name]
    return JaxAbstractMesh(sizes, names), shd.AbstractMesh(sizes, names)


def _paths(tree, prefix=()):
    """{path: leaf} of a tree of dicts, lists and tuples of leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)) and not shd.is_axes_leaf(tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _specs(shapes, axes, mesh, spec_fn, rules):
    s, a = _paths(shapes), _paths(axes)
    assert s.keys() == a.keys()
    return {k: tuple(spec_fn(s[k].shape, a[k], mesh, rules)) for k in s}


def _param_specs(arch, name):
    jmesh, tmesh = _meshes(name)
    ref_model = ref_model_for(ref_registry.get_config(arch))
    model = model_for(registry.get_config(arch))
    want = _specs(ref_model.abstract_params(), ref_model.axes(), jmesh,
                  ref_shd.spec_for_shape, ref_shd.PARAM_RULES)
    got = _specs(model.abstract_params(), model.axes(), tmesh, shd.spec_for_shape,
                 shd.PARAM_RULES)
    return got, want


def _cache_shape(arch):
    """(batch, seq) of the arch's decode shapes, the long one where it runs."""
    shapes = registry.applicable_shapes(registry.get_config(arch))
    out = [(registry.SHAPES["decode_32k"].global_batch, registry.SHAPES["decode_32k"].seq_len)]
    if "long_500k" in shapes:
        out.append((registry.SHAPES["long_500k"].global_batch,
                    registry.SHAPES["long_500k"].seq_len))
    return out


def _cache_specs(arch, name, batch, seq):
    jmesh, tmesh = _meshes(name)
    ref_cfg, cfg = ref_registry.get_config(arch), registry.get_config(arch)
    ref_model, model = ref_model_for(ref_cfg), model_for(cfg)
    if cfg.encdec:
        ref_cache = ref_model.init_cache(batch, seq, enc_len=dryrun.ENC_LEN_DECODE, abstract=True)
        cache = model.init_cache(batch, seq, dryrun.ENC_LEN_DECODE, device="meta")
    else:
        ref_cache = ref_model.init_cache(batch, seq, abstract=True)
        cache = model.init_cache(batch, seq, device="meta")
    want = {k: tuple(v.spec) for k, v in _paths(
        ref_shd.cache_shardings(ref_cache, ref_cfg, jmesh)).items()}
    got = {k: v.spec for k, v in _paths(shd.cache_shardings(cache, cfg, tmesh)).items()}
    shapes = {k: tuple(v.shape) for k, v in _paths(cache).items()}
    ref_shapes = {k: tuple(v.shape) for k, v in _paths(ref_cache).items()}
    assert shapes == ref_shapes
    return got, want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    got, want = _param_specs(arch, mesh)
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    for batch, seq in _cache_shape(arch):
        got, want = _cache_specs(arch, mesh, batch, seq)
        assert got == want, (batch, seq)


def test_opt_rules_are_the_references():
    assert dryrun.OPT_RULES == REF_OPT_RULES


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("variant", sorted(REF_OPT_RULES))
def test_specs_match_reference_under_rule_variants(variant, mesh):
    """Every arch's parameter and cache specs under one named variant,
    applied through each package's ``rule_overrides``."""
    upd = REF_OPT_RULES[variant]
    with ref_shd.rule_overrides(**upd), shd.rule_overrides(**upd):
        for arch in ARCHS:
            got, want = _param_specs(arch, mesh)
            assert got == want, (arch, "params")
            for batch, seq in _cache_shape(arch):
                got, want = _cache_specs(arch, mesh, batch, seq)
                assert got == want, (arch, batch, seq)
    assert shd.PARAM_RULES == ref_shd.PARAM_RULES  # restored on exit
    assert shd.CACHE_RULES == ref_shd.CACHE_RULES
    assert shd.ACT_RULES == ref_shd.ACT_RULES


def test_rule_tables_are_the_references():
    assert shd.PARAM_RULES == ref_shd.PARAM_RULES
    assert shd.ACT_RULES == ref_shd.ACT_RULES
    assert shd.CACHE_RULES == ref_shd.CACHE_RULES


# --- twins of tests/test_training_substrate.py::TestShardingRules -------------


class TestShardingRules:
    def test_divisibility_fallback(self):
        mesh = shd.AbstractMesh((1, 1), ("data", "model"))
        spec = shd.spec_for_shape((64, 128), ("embed", "mlp"), mesh, shd.PARAM_RULES)
        assert spec == tuple(P("data", "model"))

    def test_abstract_mesh_divisibility(self):
        mesh = shd.AbstractMesh((16, 16), ("data", "model"))
        spec = shd.spec_for_shape(
            (2048, 8, 128), ("embed", "kv_heads", "head_dim"), mesh, shd.PARAM_RULES)
        assert spec == tuple(P("data", None, "model"))
        spec = shd.spec_for_shape(
            (1, 524288, 8, 128), ("batch", "seq", "kv_heads", "head_dim"), mesh,
            shd.CACHE_RULES)
        assert spec == tuple(P(None, "data", None, "model"))
        spec = shd.spec_for_shape(
            (8, 4096, 14336), ("expert", "embed", "mlp"), mesh, shd.PARAM_RULES)
        assert spec == tuple(P(None, "data", "model"))

    def test_multi_axis_batch(self):
        mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
        spec = shd.spec_for_shape((256, 4096), ("batch", "seq"), mesh, shd.ACT_RULES)
        assert spec == tuple(P(("pod", "data")))


# --- train state and batch ----------------------------------------------------


def _sharding_specs(tree):
    return {k: tuple(v.spec) for k, v in _paths(tree).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x7b", "whisper-large-v3"])
def test_state_and_batch_shardings_match_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    ref_model = ref_model_for(ref_registry.get_config(arch))
    model = model_for(registry.get_config(arch))
    want = ref_train_loop.shardings_for_state(ref_model, jmesh)
    got = train_loop.shardings_for_state(model, tmesh)
    assert _sharding_specs(got.params) == _sharding_specs(want.params)
    assert _sharding_specs(got.opt.m) == _sharding_specs(want.opt.m)
    assert _sharding_specs(got.opt.v) == _sharding_specs(want.opt.v)
    assert got.opt.step.spec == tuple(want.opt.step.spec) == ()
    for shape, axes in (((256, 4096), None), ((3, 256, 4096), (None, "batch", "seq")),
                        ((256, 1500, 1280), ("batch", "seq", "embed")), ((128,), None)):
        assert train_loop.batch_sharding(tmesh, shape, axes).spec == tuple(
            ref_train_loop.batch_sharding(jmesh, shape, axes).spec)


def test_abstract_state_matches_reference_shapes():
    for arch in ("granite-3-2b", "rwkv6-1.6b"):
        ref = ref_train_loop.abstract_state(ref_model_for(ref_registry.get_config(arch)))
        got = train_loop.abstract_state(model_for(registry.get_config(arch)))
        ref_leaves = {k: (tuple(v.shape), str(v.dtype)) for k, v in _paths(ref.params).items()}
        leaves = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for k, v in _paths(got.params).items()}
        assert leaves == ref_leaves
        assert all(t.device.type == "meta" for t in _paths(got).values())
        assert got.opt.step.dtype == torch.int32 and got.opt.step.shape == ()
        assert all(t.dtype == torch.float32 for t in _paths(got.opt.m).values())


# --- the order of a dim sharded over two mesh axes ----------------------------


@pytest.mark.parametrize("rank", [1, 2, 5, 6])
def test_two_axis_shard_order_is_mesh_dim_order(rank):
    """``CACHE_RULES["seq"] = ["data", "pod"]`` gives ("data", "pod") on a
    (pod, data, model) mesh: the reference lays the sequence out
    data-major, the port's plain Shard placements pod-major (ROADMAP §C,
    a departure). Each rank's shard shape is the same either way; DTensor
    puts it where ``shard_offset(order="port")`` says."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.launch.mesh import destroy_process_group, ensure_process_group

    ensure_process_group("fake", 8, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        shape = (1, 16, 4, 8)
        spec = shd.spec_for_shape(shape, ("batch", "seq", "kv_heads", "head_dim"), mesh,
                                  shd.CACHE_RULES)
        assert spec == (None, ("data", "pod"), "model")
        assert spec == tuple(ref_shd.spec_for_shape(
            shape, ("batch", "seq", "kv_heads", "head_dim"),
            JaxAbstractMesh((2, 2, 2), ("pod", "data", "model")), ref_shd.CACHE_RULES))
        local, offset = compute_local_shape_and_global_offset(
            shape, mesh, shd.to_placements(spec, mesh))
        coord = dict(zip(("pod", "data", "model"), mesh.get_coordinate()))
        assert tuple(local) == shd.local_shape(shape, spec, mesh) == (1, 4, 2, 8)
        assert tuple(offset) == shd.shard_offset(shape, spec, mesh, coord, order="port")
        ref_offset = shd.shard_offset(shape, spec, mesh, coord, order="reference")
        # data-major: the seq offset is (data * 2 + pod) * 4; pod-major (pod * 2 + data) * 4
        assert ref_offset[1] == (coord["data"] * 2 + coord["pod"]) * 4
        assert offset[1] == (coord["pod"] * 2 + coord["data"]) * 4
        assert (offset == ref_offset) == (coord["pod"] == coord["data"])
    finally:
        destroy_process_group()


def test_device_mesh_specs_equal_abstract_mesh_specs():
    from repro_torch.launch.mesh import destroy_process_group, make_production_mesh

    mesh = make_production_mesh()
    try:
        assert shd.mesh_shape(mesh) == {"data": 16, "model": 16}
        model = model_for(registry.get_config("granite-3-2b"))
        abstract = shd.AbstractMesh((16, 16), ("data", "model"))
        a = shd.tree_shardings(model.abstract_params(), model.axes(), abstract)
        d = shd.tree_shardings(model.abstract_params(), model.axes(), mesh)
        assert _sharding_specs(a) == _sharding_specs(d)
        for leaf in _paths(d).values():
            assert len(leaf.placements) == 2
    finally:
        destroy_process_group()


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.to_placements((), mesh) == (Replicate(),) * 3
    assert shd.to_placements((None, ("data", "pod")), mesh) == (Shard(1), Shard(1), Replicate())


# --- the resolver outside a mesh ----------------------------------------------


def test_resolver_is_identity_on_plain_tensors():
    mesh = shd.AbstractMesh((16, 16), ("data", "model"))
    x = torch.randn(4, 8, 16)
    assert sharding_hooks.constrain(x, ("batch", "seq", "embed")) is x
    shd.install_activation_resolver(mesh)
    try:
        assert sharding_hooks.constrain(x, ("batch", "seq", "embed")) is x
    finally:
        shd.clear_activation_resolver()
    assert sharding_hooks.constrain(x, ("batch", "seq", "embed")) is x


def test_resolver_leaves_a_plain_forward_unchanged():
    cfg = registry.tiny("granite-3-2b")
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    want, _ = model.forward(params, tokens)
    shd.install_activation_resolver(shd.AbstractMesh((16, 16), ("data", "model")))
    try:
        got, _ = model.forward(params, tokens)
    finally:
        shd.clear_activation_resolver()
    assert torch.equal(got, want)


def test_local_shape_divides_by_the_spec():
    mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.local_shape((256, 4096, 64), (("pod", "data"), None, "model"), mesh) == (
        8, 4096, 4)
    assert math.prod(shd.local_shape((2048, 8, 128), ("data", None, "model"), mesh)) == (
        2048 * 8 * 128 // 256)
