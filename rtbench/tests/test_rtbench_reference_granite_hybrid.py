"""The granite_hybrid family (granite-4.0-h-micro) against the port's model
on the same weights, and its cell run whole at tiny size on the CPU.

The family's sizes are the published config's (a Mamba-2 head of 64, a
state of 128, an inner width of twice the model's), so the port's tiny
config is taken at those: two Mamba-2 heads over the tiny width of 64.
The test imports the port; the reference does not (see
``test_rtbench_imports.py``)."""
import dataclasses
import time

import pytest
import torch

from repro_torch.configs.registry import tiny
from repro_torch.models import model_for
from rtbench import spec
from rtbench.harness import dims_of
from rtbench.reference import models, weights
from rtbench.tests.helpers import TINY_CHAT, make_bench, steady

ARCH, FAMILY, CELL = "granite-4.0-h-micro", "granite_hybrid", "granite4h.chat"


def _setup(seed=3, n_layers=10):
    fam = spec.family(FAMILY)
    cfg = tiny(ARCH, n_layers=n_layers, ssm_heads=fam.EXPAND * 64 // fam.SSM_HEAD_DIM,
               ssm_head_dim=fam.SSM_HEAD_DIM, ssm_state=fam.SSM_STATE)
    dims = dims_of(dataclasses.asdict(cfg))
    return cfg, dims, fam, weights.make(fam, dims, seed, "cpu", torch.float32)


def _shapes(t, prefix=()):
    if isinstance(t, dict):
        return {k: v for key, sub in t.items() for k, v in _shapes(sub, prefix + (key,)).items()}
    if isinstance(t, list):
        return {k: v for i, sub in enumerate(t) for k, v in _shapes(sub, prefix + (i,)).items()}
    return {prefix: tuple(t.shape)}


@pytest.mark.parametrize("n_layers", [10, 20])
def test_tree_matches_the_ports_parameters(n_layers):
    cfg, _, _, tree = _setup(n_layers=n_layers)
    assert _shapes(tree) == _shapes(model_for(cfg).abstract_params(torch.float32))


def test_forward_matches_the_port():
    cfg, dims, fam, tree = _setup()
    toks = torch.randint(0, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port, _ = model_for(cfg).forward(tree, toks)
    ref = models.logits(tree, models.hidden(fam, tree, toks, dims))
    assert torch.allclose(port, ref, atol=2e-5, rtol=0)


def test_decode_steps_match_the_full_forward():
    """The port's decode through its cache, token by token, against the
    reference's one causal pass: what the check relies on."""
    cfg, dims, fam, tree = _setup(seed=5)
    m = model_for(cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 20), generator=torch.Generator().manual_seed(1))
    cache = m.init_cache(1, 24, device="cpu")
    steps = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = m.decode_step(tree, cache, toks[:, t], torch.tensor([t], dtype=torch.int32))
            steps.append(lg[0])
    ref = models.logits(tree, models.hidden(fam, tree, toks, dims))[0]
    assert torch.allclose(torch.stack(steps), ref, atol=2e-5, rtol=0)


def test_published_config_and_counts():
    """The configuration file runs the published sizes, its port section
    builds the registry's config, and the family counts the 36 + 4 layers'
    matrix weights as the port's parameters have them."""
    cell = spec.load_cell(CELL)
    cfg = cell.config_spec()
    assert cfg["reduced"] == [] and cfg["block_family"] == FAMILY
    port = cfg["port"]
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.registry import get_config

    built = ModelConfig(**{**port, "block_pattern": tuple(port["block_pattern"])})
    assert dataclasses.replace(built, source="") == dataclasses.replace(get_config(ARCH), source="")
    assert cfg["mamba_n_heads"] == port["ssm_heads"] and cfg["mamba_d_state"] == port["ssm_state"]
    fam = spec.family(FAMILY)
    dims = dims_of(port)
    spec_tree = model_for(built).abstract_params()
    block = sum(t.numel() for e in spec_tree["super"] for k, sub in e.items()
                if k in ("mixer", "ffn") for t in sub.values())
    # The conv's weights and bias, dt_bias, a_log, D and the gated norm's
    # weight are no matrix a token multiplies through.
    assert fam.block_matmul_params(dims) * port["n_layers"] == pytest.approx(
        block - 36 * (5 * 4352 + 3 * 64 + 4096), rel=1e-9)
    names = [m["name"] for m in cell.per_layer]
    for name in ("ssd_chunk_roofline", "ssd_step_roofline", "held_rows_share"):
        assert name in names


def test_the_cell_runs_whole_at_tiny_size(tmp_path):
    """The harness at tiny size on the CPU, from a copy of the benchmark's
    files: the check passes, and a traced run reports the three new
    readers' metrics (the kernels' shares as None here: no device trace
    names them on the CPU)."""
    from rtbench import harness

    root = make_bench(tmp_path, [{"name": CELL, "config": ARCH, "traffic": "chat", "chips": 1,
                                  "why": "test"}], {"chat": TINY_CHAT})
    cell = spec.load_cell(CELL, root=root, bench_dir=root / "rtbench")
    out = harness.run(cell, 2**31 + 23, 2.0, True, "cpu", time.time(), tiny=True, fault=steady)
    line = out["line"]
    assert line["correct"] is True, line
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert "held_rows_share" in line["metrics"]
    assert 0.0 <= line["metrics"]["held_rows_share"]["value"] <= 100.0
    assert "ssd_step_roofline" not in line["metrics"]


def test_kernel_costs_and_the_held_rows_reader():
    """The two kernels' costs at the cell's shapes (``ssd_step``'s bytes:
    each stepped row's float32 state read and written once, 134 MB a layer
    at 32 rows), one launch a Mamba-2 layer; ``held_rows_share`` from the
    program's spans, and None where the program carries no counts (the
    parent's) or there is no tracer."""
    from types import SimpleNamespace

    from rtbench.harness import JobRecord

    costs = spec.kernel_costs()
    model = dict(n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=None)
    step = costs["ssd_step"]
    job = JobRecord(n=0, kind="decode", length=2048, real_rows=32, bucket=32, host_ns=0,
                    release_t=0.0, frames=[], decode_rows=[(i, i, 1) for i in range(32)])
    shapes = step.launch_shapes(job, model)
    assert len(shapes) == 36 and shapes[0]["rows"] == 32
    flops, nbytes = step.launch_cost(shapes[0])
    assert 2 * 32 * 64 * 64 * 128 * 4 == 134_217_728 <= nbytes < 1.05 * 134_217_728  # + conv windows
    assert flops == 5 * 32 * 64 * 64 * 128
    chunk = costs["ssd_chunk"]
    pjob = JobRecord(n=1, kind="prefill", length=512, real_rows=5, bucket=8, host_ns=0,
                     release_t=0.0, frames=[])
    cshapes = chunk.launch_shapes(pjob, model)
    assert len(cshapes) == 36 and cshapes[0]["B"] == 8 and not chunk.launch_shapes(job, model)
    assert step.launch_shapes(pjob, model) == []

    reader = spec.metric_reader("held_rows_share")
    ev = lambda t, meta: SimpleNamespace(stage="device_submit", t=t, meta=meta)
    ring = [ev(0.5, {"rows_stepped": 9, "rows_held": 1}),  # before the window
            ev(1.5, {"rows_stepped": 4, "rows_held": 28}), ev(2.5, {"rows_stepped": 8,
                                                                     "rows_held": 24}),
            ev(2.6, {"job_id": 7, "batch": 8})]  # a prefill's span carries no counts
    reading = SimpleNamespace(tracer=SimpleNamespace(ring=ring), window=(1.0, 3.0))
    assert reader.read(reading) == pytest.approx(100.0 * 52 / 64)
    reading.tracer.ring = [ev(1.5, {"job_id": 1, "batch": 4})]
    assert reader.read(reading) is None
    reading.tracer = None
    assert reader.read(reading) is None
