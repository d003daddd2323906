"""The port's roofline (``repro_torch.roofline``) against the JAX package's.

Twins of ``tests/test_roofline_and_serving.py``'s ``TestJaxprFlops`` and
``TestHloCost`` for the op counter and the collective counter (eager code
runs every layer, so L layers count L times one; remat's recomputation
counts in the backward), ``model_flops_for`` equal to the reference's for
every config and shape, the global-against-per-rank split on a fake
(16, 16) group, and a tiny-config dry run on it whose per-rank argument
bytes are the sum of the local shapes the reference's specs give.
"""
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.utils.checkpoint import checkpoint

from repro.configs import registry as ref_registry
from repro.models import model_for as ref_model_for
from repro.roofline import analysis as ref_analysis
from repro.training import train_loop as ref_train_loop
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import destroy_process_group, ensure_process_group
from repro_torch.roofline import analysis, comm_cost
from repro_torch.roofline.op_cost import OpCost, costs_of, flops_of, run_counted


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


class TestOpFlops:
    def test_plain_matmul(self):
        M, K, N = 32, 64, 128
        assert flops_of(lambda a, b: a @ b, _f32(M, K), _f32(K, N)) == 2 * M * N * K

    def test_layers_count_each_time(self):
        """The reference's scan multiplies its body by the trip count; an
        eager loop runs the body L times."""
        M, L = 32, 7

        def f(x, ws):
            for w in ws:
                x = x @ w
            return x

        assert flops_of(f, _f32(M, M), _f32(L, M, M)) == L * 2 * M**3

    def test_remat_counts_the_recompute(self):
        """fwd (1) + remat-fwd (1) + bwd (2 matmuls) = 4 matmuls a layer. x
        requires a gradient too: the reference's scan body computes both
        cotangents on every layer, eager autograd would skip x's."""
        M, L = 16, 3

        def f(x, ws):
            h = x
            for w in ws:
                h = checkpoint(lambda a, b: torch.tanh(a @ b), h, w, use_reentrant=False)
            return h.sum()

        def g(ws, x):
            return torch.autograd.grad(f(x, ws), (ws, x))

        ws = _f32(L, M, M).requires_grad_()
        x = _f32(M, M).requires_grad_()
        assert flops_of(g, ws, x) == L * 4 * 2 * M**3

    def test_batched_einsum(self):
        B, S, H, D = 2, 8, 4, 16
        f = lambda q, k: torch.einsum("bshd,bthd->bhst", q, k)
        assert flops_of(f, _f32(B, S, H, D), _f32(B, S, H, D)) == 2 * B * H * S * S * D

    def test_bytes_exclude_attention_internal(self):
        """The logits (rank-5 float32) are internal and not counted; the
        operands are, as the products read them: the port's attention
        upcasts q and k to float32 first, so they count at 4 bytes an
        element (the reference's bf16 operands count 2)."""
        def f(q, k):
            return torch.einsum("bkgqd,bskd->bkgqs", q.float(), k.float())

        q = torch.zeros((2, 2, 2, 8, 16), dtype=torch.bfloat16)
        k = torch.zeros((2, 8, 2, 16), dtype=torch.bfloat16)
        _, b = costs_of(f, q, k)
        assert b == q.numel() * 4 + k.numel() * 4

    def test_matmul_bytes_are_operands_and_result(self):
        M, K, N = 8, 16, 32
        _, b = costs_of(lambda a, w: a @ w, _f32(M, K), _f32(K, N))
        assert b == 4 * (M * K + K * N + M * N)

    def test_elementwise_counts_no_bytes(self):
        _, b = costs_of(lambda a: torch.tanh(a) * 2 + 1, _f32(64, 64))
        assert b == 0


class TestCollectiveCount:
    def test_loop_counts_every_iteration(self):
        """The reference multiplies a while body by its known trip count;
        here each of the loop's L products and collectives is executed and
        counted."""
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol

        L = 9
        ensure_process_group("fake", 2)
        try:
            with OpCost() as oc:
                h = _f32(64, 64)
                for _ in range(L):
                    h = torch.tanh(h @ _f32(64, 64))
                    h = funcol.wait_tensor(funcol.all_reduce(h, "sum", dist.group.WORLD))
            r = oc.result()
        finally:
            destroy_process_group()
        assert r["flops_global"] == L * 2 * 64**3
        assert r["collectives"]["calls"]["all-reduce"] == L
        assert r["collectives"]["bytes"]["all-reduce"] == L * 64 * 64 * 4

    def test_collective_bytes_per_executed_call(self):
        """Twin of the HLO-text case: an all-reduce of f32[128] executed 5
        times counts 5 x 128 x 4 bytes."""
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol

        ensure_process_group("fake", 2)
        try:
            with comm_cost.CollectiveCounter() as cc:
                a = _f32(128)
                for _ in range(5):
                    a = funcol.wait_tensor(funcol.all_reduce(a, "sum", dist.group.WORLD))
                gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
                g = funcol.wait_tensor(gather(_f32(16, 8), 0, dist.group.WORLD))
        finally:
            destroy_process_group()
        assert cc.count.bytes["all-reduce"] == 5 * 128 * 4
        assert cc.count.calls == {"all-gather": 1, "all-reduce": 5, "reduce-scatter": 0,
                                  "all-to-all": 0, "collective-permute": 0}
        assert cc.count.bytes["all-gather"] == 16 * 8 * 4 and g.shape == (32, 8)

    def test_kinds_of_ops(self):
        assert comm_cost.kind_of(torch.ops._c10d_functional.all_gather_into_tensor.default) == (
            "all-gather")
        assert comm_cost.kind_of(torch.ops._c10d_functional.reduce_scatter_tensor.default) == (
            "reduce-scatter")
        assert comm_cost.kind_of(torch.ops.aten.mm.default) is None


def test_global_and_local_counts_under_dtensor():
    """On a fake (16, 16) group an (M, K) x (K, N) product sharded on M over
    data and on N over model: the global count is the whole product's, this
    rank's the shard's (1 / 256), and the gather it needs is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            a = DTensor.from_local(torch.empty(64, 128), mesh, [Shard(0), Replicate()],
                                   run_check=False)
            b = DTensor.from_local(torch.empty(128, 32), mesh, [Replicate(), Shard(1)],
                                   run_check=False)
            _, r = run_counted(lambda a, b: a @ b, a, b)
    finally:
        destroy_process_group()
    total = 2 * 1024 * 128 * 512
    assert r["flops_global"] == total
    assert r["flops_local"] == total / 256
    rep = analysis.analyze(r, n_devices=256)
    assert rep.flops == total / 256
    assert rep.compute_s == rep.flops / analysis.PEAK_FLOPS


def test_a_local_region_counts_once_per_shard_globally():
    """Code that runs on one of n even shards outside DTensor (the kernels'
    shard view, MoE's local path) is this rank's work once and the global
    program's n times."""
    from repro_torch.distributed.sharding import local_region

    def f(a, b):
        with local_region(4):
            return a @ b

    _, r = run_counted(f, _f32(8, 16), _f32(16, 32))
    assert r["flops_local"] == 2 * 8 * 16 * 32
    assert r["flops_global"] == 4 * r["flops_local"]
    assert r["bytes_global"] == 4 * r["bytes_local"] == 4 * 4 * (8 * 16 + 16 * 32 + 8 * 32)


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_model_flops_for_matches_reference(arch):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    assert cfg.active_param_count_estimate() == ref_cfg.active_param_count_estimate()
    for shape in registry.applicable_shapes(cfg):
        spec = registry.SHAPES[shape]
        got = analysis.model_flops_for(cfg, spec.kind, spec.seq_len, spec.global_batch)
        want = ref_analysis.model_flops_for(ref_cfg, spec.kind, spec.seq_len, spec.global_batch)
        assert got == want, shape


def test_report_terms_and_dominant():
    counts = {"flops_global": 256 * 989e12, "flops_local": 1.0, "bytes_global": 256 * 3.35e12,
              "bytes_local_all_ops": 9.0,
              "collectives": {"bytes": {"all-gather": 900e9, "all-reduce": 0.0}}}
    rep = analysis.analyze(counts, model_flops_global=256 * 494.5e12, n_devices=256)
    assert rep.compute_s == pytest.approx(1.0) and rep.memory_s == pytest.approx(1.0)
    assert rep.collective_s == pytest.approx(2.0) and rep.dominant == "collective"
    assert rep.bound_time == rep.collective_s
    assert rep.useful_flops_ratio == pytest.approx(0.5)
    d = rep.to_dict()
    assert d["hbm_bytes_upper_per_device"] == 9.0
    assert set(d) == set(ref_analysis.RooflineReport(0, 0, 0, {}, 0, 0, 0).to_dict())


def test_constants_are_the_h100s():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_roofline_table_of_cells():
    ok = {"arch": "a", "shape": "train_4k", "mesh": "16x16", "opt": "baseline", "ok": True,
          "roofline": {"compute_s": 2e-3, "memory_s": 1e-3, "collective_s": 5e-4,
                       "dominant": "compute", "useful_flops_ratio": 0.5},
          "memory_analysis": {"argument_size_in_bytes": 2e9}}
    alt = dict(ok, opt="seqpar", roofline=dict(ok["roofline"], compute_s=1e-3))
    bad = {"arch": "b", "shape": "decode_32k", "mesh": "16x16", "ok": False,
           "error": "RuntimeError: no"}
    t = analysis.roofline_table([ok, alt, bad])
    assert t["rows"][0][:9] == ["a", "train_4k", "16x16", "baseline", "ok", "2.000e-03",
                                "1.000e-03", "5.000e-04", "compute"]
    assert t["rows"][0][10] == "2.00" and t["rows"][2][4] == "FAIL"
    assert t["best_rows"] == [["a", "train_4k", "16x16", "2.000e-03", "1.000e-03", "seqpar",
                               "compute", "2.0"]]
    assert t["summary"][:2] == ["roofline,cells_ok,2", "roofline,cells_fail,1"]


# --- a tiny dry run on a fake (16, 16) group ------------------------------------

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int32": 4}


def _ref_local_bytes(shape, dtype, spec, mesh):
    n = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            n[d] //= mesh.shape[a]
    return math.prod(n) * DTYPE_BYTES[dtype]


def test_tiny_dry_run_argument_bytes_match_reference_specs():
    arch, B, S = "granite-3-2b", 256, 32
    cell = dryrun.run_cell(arch, "train_4k", False, cfg=registry.tiny(arch), seq_len=S,
                           global_batch=B)
    jmesh = JaxAbstractMesh((16, 16), ("data", "model"))
    ref_model = ref_model_for(ref_registry.tiny(arch))
    shapes = ref_train_loop.abstract_state(ref_model)
    shards = ref_train_loop.shardings_for_state(ref_model, jmesh)
    leaves = jax.tree.leaves(shapes)
    specs = jax.tree.leaves(shards, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(specs)
    want = sum(_ref_local_bytes(l.shape, str(l.dtype), s.spec, jmesh)
               for l, s in zip(leaves, specs))
    tok_spec = ref_train_loop.batch_sharding(jmesh, (B, S)).spec
    want += _ref_local_bytes((B, S), "int32", tok_spec, jmesh)
    assert cell["ok"] and cell["mesh"] == "16x16"
    assert cell["memory_analysis"]["argument_size_in_bytes"] == want
    r = cell["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["flops_per_device"] >= cell["counts"]["flops_global"] / 256
    assert cell["counts"]["collectives"]["calls"]["all-gather"] > 0
    assert r["model_flops_per_device"] == pytest.approx(ref_analysis.model_flops_for(
        ref_registry.tiny(arch), "train", S, B) / 256)


def test_dry_run_cli_writes_a_failed_cell_and_exits_non_zero(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("in-place write into a sharded dim")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    with pytest.raises(SystemExit, match="1 dry-run cell"):
        dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k", "--out", str(tmp_path)])
    cells = analysis.load_cells(str(tmp_path))
    assert len(cells) == 1 and cells[0]["ok"] is False
    assert "in-place write" in cells[0]["error"]
    assert dryrun.DEFAULT_OUT.startswith("build/")
