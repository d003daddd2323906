"""A cell, a configuration, a block family, a kernel's costs, a traffic
mix and a per-layer metric are found by name: adding one is new files
and BENCHMARK.json entries."""
import json
import shutil
from types import SimpleNamespace

import pytest

from rtbench import spec
from rtbench.costs import model as model_costs, peaks
from rtbench.devtrace import JobDevice
from rtbench.harness import JobRecord
from rtbench.tests.helpers import HERE, TINY_PROMPTS, make_bench, steady
from rtbench.traffic import plan

NEW_METRIC = '''"""Jobs dispatched in the window (a test's metric)."""
LAYER = "EDF worker"
UNIT = "jobs"
MOVES = "goodput_tok_s"


def read(reading):
    return float(len(reading.jobs)) if reading.jobs else None
'''


# A kernel the repo's costs do not know, run by the new family's model.
NEW_KERNEL = '''"""A test's kernel: one launch a layer over a prefill's rows."""
MATCH = r"newkern_kernel"


def launch_shapes(job, model):
    if job.kind != "prefill":
        return []
    return [dict(B=job.bucket, S=job.length)] * model["n_layers"]


def launch_cost(shape):
    return float(1000 * shape["B"] * shape["S"]), float(10 * shape["B"] * shape["S"])
'''

NEW_ROOFLINE = '''"""newkern's bound time over its measured time (a test's metric)."""
from rtbench.metrics import _common

LAYER = "kernels (kernels/)"
UNIT = "%"
MOVES = "goodput_tok_s"


def read(reading):
    return _common.roofline_share(reading, "newkern")
'''


@pytest.fixture
def bench(tmp_path):
    cells = [{"name": "newmodel.burst", "config": "newmodel", "traffic": "burst", "chips": 1,
              "why": "test"}]
    root = make_bench(tmp_path, cells, {"burst": dict(TINY_PROMPTS, classes=[
        dict(TINY_PROMPTS["classes"][0], source="burst", burst=2, duty=0.5)])})
    b = root / "rtbench"
    # The new configuration's model is of a new block family (its file a
    # copy of rwkv's, under its own name) and runs a new kernel.
    cfg = json.loads((b / "configs" / "rwkv6-1.6b.json").read_text())
    cfg["block_family"] = "newfam"
    cfg["serving"]["kernels"] = ["wkv6", "newkern"]
    (b / "configs" / "newmodel.json").write_text(json.dumps(cfg))
    shutil.copy(b / "families" / "rwkv.py", b / "families" / "newfam.py")
    (b / "costs" / "newkern.py").write_text(NEW_KERNEL)
    (b / "metrics" / "jobs_dispatched.py").write_text(NEW_METRIC)
    (b / "metrics" / "newkern_roofline.py").write_text(NEW_ROOFLINE)
    bj = json.loads((root / "BENCHMARK.json").read_text())
    bj["per_layer"].append({"name": "jobs_dispatched", "unit": "jobs", "better": "higher",
                            "source": "program_counter", "layer": "EDF worker",
                            "moves": "goodput_tok_s", "workloads": ["newmodel.burst"]})
    bj["per_layer"].append({"name": "newkern_roofline", "unit": "%", "better": "higher",
                            "source": "device_trace", "layer": "kernels (kernels/)",
                            "moves": "goodput_tok_s", "workloads": ["newmodel.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bj))
    return root


def test_new_cell_config_mix_and_metric_are_found(bench):
    cell = spec.load_cell("newmodel.burst", root=bench, bench_dir=bench / "rtbench")
    assert cell.config_spec()["name"] == "rwkv6-1.6b"
    mix = cell.traffic_mix()
    assert mix["classes"][0]["source"] == "burst"
    names = [m["name"] for m in cell.per_layer]
    assert "jobs_dispatched" in names and "idle_share" in names
    reader = spec.metric_reader("jobs_dispatched", cell.bench_dir)
    assert reader.UNIT == "jobs"
    streams = plan.streams(mix, seed=9, seconds=2.0, vocab=256)
    assert streams and all(s.source.plan() for s in streams)


def test_a_new_family_and_kernel_cost_are_used(bench):
    """The new family gives the step's operations and the new kernel's
    file its launches' shapes and costs, read from a traced job."""
    bench_dir = bench / "rtbench"
    cell = spec.load_cell("newmodel.burst", root=bench, bench_dir=bench_dir)
    fam = spec.family(cell.config_spec()["block_family"], bench_dir)
    assert fam.__file__ == str(bench_dir / "families" / "newfam.py")
    model = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=None, d_ff=128,
                 vocab_size=256, kernels=cell.config_spec()["serving"]["kernels"])
    job = JobRecord(n=0, kind="prefill", length=96, real_rows=2, bucket=2, host_ns=0,
                    release_t=0.0, frames=[(1, 0), (2, 0)])
    dev = JobDevice(0, 4_000_000, busy_ns=4_000_000, by_kernel={"newkern": 1_000_000})
    reading = spec.Reading(cell=cell, frames=[], offered=2, admitted=2, counters={},
                           window=(0.0, 1.0), jobs=[job], trace=SimpleNamespace(jobs={0: dev}),
                           model=model, family=fam)
    bound = 3 * peaks.bound_seconds(1000 * 2 * 96, 10 * 2 * 96)
    got = spec.metric_reader("newkern_roofline", bench_dir).read(reading)
    assert got == pytest.approx(100 * bound / 1e-3)
    flops = model_costs.prefill_flops(fam, model, 2, 96)
    assert spec.metric_reader("step_mfu", bench_dir).read(reading) == pytest.approx(
        100 * flops / (4e-3 * peaks.BF16_FLOPS))
    # A model that does not name the kernel reads nothing for it.
    reading.model = dict(model, kernels=["wkv6"])
    assert spec.metric_reader("newkern_roofline", bench_dir).read(reading) is None


def test_unknown_names_are_refused(bench):
    with pytest.raises(KeyError):
        spec.load_cell("nosuch.cell", root=bench, bench_dir=bench / "rtbench")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("nosuch_metric", bench / "rtbench")
    with pytest.raises(FileNotFoundError):
        spec.family("nosuch_family", bench / "rtbench")


def test_the_repos_cells_find_their_parts():
    bj = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in bj["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config_spec()["name"] == w["config"]
        plan.check_mix(cell.traffic_mix())
        for m in cell.per_layer:
            spec.metric_reader(m["name"])
    for c in bj["configs"]:
        assert (HERE.parent / c["file"]).is_file()
        cfg = json.loads((HERE.parent / c["file"]).read_text())
        spec.family(cfg["block_family"])
        assert set(cfg["serving"]["kernels"]) <= set(spec.kernel_costs())


def test_the_new_cell_runs_with_its_new_metric(bench):
    """The whole harness at tiny size on the CPU, from the test's folder:
    nothing of rtbench's own code changed for the new cell."""
    import time

    from rtbench import harness

    cell = spec.load_cell("newmodel.burst", root=bench, bench_dir=bench / "rtbench")
    out = harness.run(cell, 2**31 + 11, 1.5, True, "cpu", time.time(), tiny=True, fault=steady)
    line = out["line"]
    assert line["correct"] is True, line
    assert line["metrics"]["jobs_dispatched"]["value"] >= 1
    assert line["attempted"] >= 1


def test_streams_offer_the_same_load_on_every_seed():
    mix = json.loads((HERE / "traffic" / "mixes" / "prompts.json").read_text())
    a = plan.streams(mix, seed=1, seconds=30.0, vocab=65536)
    b = plan.streams(mix, seed=2**31 + 5, seconds=30.0, vocab=65536)
    key = lambda ss: [(s.cls, s.length, s.period, s.deadline, s.phase, s.source.n_frames) for s in ss]
    assert key(a) == key(b)
    assert [s.source.plan()[1].offset for s in a] != [s.source.plan()[1].offset for s in b]
    # Every planned frame is due inside the window.
    assert max(s.phase + s.source.plan()[-1].offset for s in a) < 30.0
