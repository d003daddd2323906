"""Prefill as the port serves it, and the two virtual-clock examples, on
the CPU against the JAX package.

- ``Transformer.last_logits`` (the head on the last position alone, what
  the engine's prefill step runs) against ``forward``'s last position,
  for every arch the engine serves, at 2e-3 (the model logits' tolerance);
- the engine's prefill argmax against the JAX engine's on the same
  converted parameters, every served arch, batches 1, 3 and 8;
- zero prefill builds after the profiler's warm-up and a served run, in
  both packages (``stats["prefill_compiles"]``; on the card the port
  counts captures there);
- ``launch.quickstart`` and ``launch.cluster_sim`` against
  ``examples/quickstart.py`` and ``examples/cluster_sim.py`` run through
  ``runpy``: the printed lines are equal (both run on the virtual clock);
  the port's ``paper_table`` equals ``benchmarks.common.paper_table``.
"""
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as bcommon
from repro.configs.registry import tiny as jtiny
from repro.core import Category as JCategory, Request as JRequest
from repro.serving import batcher_bridge as jbridge
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import interop
from repro_torch.configs.registry import ARCHS, tiny
from repro_torch.core import Category, Request
from repro_torch.launch import cluster_sim, quickstart, serve
from repro_torch.models import model_for
from repro_torch.serving import batcher_bridge
from repro_torch.serving.engine import InferenceEngine

ROOT = Path(__file__).resolve().parent.parent
SERVED = [a for a in ARCHS if a not in serve.MODEL_API_ONLY]
SEQ = 16
# recurrentgemma at 5 layers: its rglru and swa blocks, then a tail.
OVERRIDES = {"recurrentgemma-9b": {"n_layers": 5}}


def _pair(arch):
    """(JAX engine, port engine on the JAX engine's parameters)."""
    kw = OVERRIDES.get(arch, {})
    jeng = JEngine({arch: jtiny(arch, **kw)}, max_slots=4)
    cfg = tiny(arch, **kw)
    params = interop.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jeng.params[arch]), device="cpu")
    return jeng, InferenceEngine({arch: cfg}, max_slots=4, device="cpu",
                                 params={arch: params})


def test_every_served_arch_is_covered():
    assert len(SERVED) == 8 and "whisper-large-v3" not in SERVED


@pytest.mark.parametrize("arch", SERVED)
def test_last_logits_equal_forward_at_the_last_position(arch):
    cfg = tiny(arch, **OVERRIDES.get(arch, {}))
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, size=(3, SEQ)).astype(np.int64))
    with torch.no_grad():
        full, _ = model.forward(params, toks)
        last = model.last_logits(params, toks)
    assert last.shape == (3, cfg.vocab_size) and last.dtype == torch.float32
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", SERVED)
def test_served_prefill_argmax_matches_jax_engine(arch):
    """Batches 1, 3 and 8 (buckets 1, 4 and 8; padded rows are zero
    frames in both engines)."""
    jeng, teng = _pair(arch)
    rng = np.random.default_rng(5)
    for batch in (1, 3, 8):
        toks = rng.integers(0, 256, size=(batch, SEQ)).astype(np.int32)
        jout = np.asarray(jeng.dispatch(arch, (SEQ,), batch, "prefill", payload=toks).wait())
        h = teng.dispatch(arch, (SEQ,), batch, "prefill", payload=toks)
        tout = h.wait().numpy()
        assert tout.shape == jout.shape == (h.bucket_batch,)
        np.testing.assert_array_equal(tout, jout)
    assert teng.stats["prefill_compiles"] == jeng.stats["prefill_compiles"] == 3


def _serve_prefill(build, config, category, request, arch):
    """Warm up through the package's ``build_live_scheduler``, serve one
    prefill stream, then dispatch every true batch 1..8 directly; returns
    (prefill builds after warm-up, frames completed)."""
    cats = [(arch, (SEQ,), "prefill")]
    sched, engine, _ = build({arch: config(arch)}, cats, batch_sizes=(1, 2, 4, 8))
    res = sched.submit_request(request(
        category(arch, (SEQ,)), period=0.5, relative_deadline=5.0, n_frames=3,
        start_time=sched.loop.now + 0.05))
    assert res.admitted
    m = sched.run()
    for b in range(1, 9):
        engine.dispatch(arch, (SEQ,), b, "prefill").wait()
    sched.device.close()
    return engine.stats["prefill_compiles"], m.completed_frames


def test_prefill_builds_stay_zero_after_warm_up_in_both_packages():
    arch = "granite-3-2b"
    port = _serve_prefill(
        lambda *a, **kw: batcher_bridge.build_live_scheduler(*a, device="cpu", **kw),
        tiny, Category, Request, arch)
    ref = _serve_prefill(jbridge.build_live_scheduler, jtiny, JCategory, JRequest, arch)
    assert port == ref == (0, 3)


def _printed(run, capsys):
    run()
    return capsys.readouterr().out


def test_quickstart_prints_what_the_reference_prints(capsys):
    want = _printed(lambda: runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                                           run_name="__main__"), capsys)
    metrics = None

    def port():
        nonlocal metrics
        metrics = quickstart.main()

    got = _printed(port, capsys)
    assert got == want
    assert got.count("ADMITTED") == 3 and "Theorem 1 held" in got
    assert metrics.missed_frames == 0 and metrics.completed_frames == 270


def test_cluster_sim_prints_what_the_reference_prints(capsys):
    want = _printed(lambda: runpy.run_path(str(ROOT / "examples" / "cluster_sim.py"),
                                           run_name="__main__"), capsys)
    agg = None

    def port():
        nonlocal agg
        agg = cluster_sim.main()

    got = _printed(port, capsys)
    assert got == want
    lines = got.splitlines()
    assert lines[0] == "placed 39/40 requests across 4 slices"
    assert "slice0 FAILS" in got and "slice1 degrades 3x" in got
    assert lines[-1] == (
        f"final: completed={agg['completed_frames']} missed={agg['missed_frames']} "
        f"(miss rate {agg['miss_rate']:.2%}) rerouted={agg['reroutes']} "
        f"dropped={agg['dropped_requests']}")


@pytest.mark.parametrize("kw", [
    {},
    {"models": ["resnet50", "vgg19"], "resolutions": [(3, 480, 854)], "max_batch": 8},
], ids=["default", "cut"])
def test_paper_table_equals_the_reference_benchmarks(kw):
    got, want = cluster_sim.paper_table(**kw), bcommon.paper_table(**kw)
    assert got.entries == want.entries
    assert got.flat_entries == want.flat_entries == {}


def test_paper_table_constants_equal_the_reference():
    assert cluster_sim.PAPER_BATCH1 == bcommon.PAPER_BATCH1
    assert cluster_sim.BATCH_SLOPE == bcommon.BATCH_SLOPE
    assert cluster_sim.RESOLUTIONS == bcommon.RESOLUTIONS
    for shape in bcommon.RESOLUTIONS + [(3, 112, 112)]:
        assert cluster_sim.pixel_scale(shape) == bcommon.pixel_scale(shape)
