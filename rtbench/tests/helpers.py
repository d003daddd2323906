"""A benchmark folder of the tests' own, built from rtbench's files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]

# Tiny mixes the CPU can serve with room to spare (its tiny WCETs are
# noisy, and a decode step's first profiled run can take a third of a
# second): a few decode streams and prompts of the tiny lengths.
TINY_CHAT = {"why": "test", "order": "classes", "classes": [
    {"name": "decode", "kind": "decode", "count": 3, "period_s": 0.25, "deadline_s": 2.0,
     "source": "camera", "jitter": 0.2},
    {"name": "prompt16", "kind": "prefill", "length": 16, "count": 2, "period_s": 0.5,
     "deadline_s": 1.0, "source": "camera", "jitter": 0.2}]}
TINY_PROMPTS = {"why": "test", "order": "interleave", "classes": [
    {"name": "p8", "kind": "prefill", "length": 8, "count": 2, "period_s": 0.4,
     "deadline_s": 0.8, "source": "camera", "jitter": 0.2},
    {"name": "p24", "kind": "prefill", "length": 24, "count": 1, "period_s": 0.4,
     "deadline_s": 0.8, "source": "periodic"}]}


def steady(slices, fault=None):
    """A harness hook for tests: every profiled WCET set to 5 ms, so that
    admission takes the tiny mixes whatever else loads the CPU (then
    ``fault``, if given, breaks the timed path)."""
    for sl in slices.values():
        table = sl.spec.table
        for curve in table.entries.values():
            for b in curve:
                curve[b] = 0.005
        for key, (slots, _) in list(table.flat_entries.items()):
            table.flat_entries[key] = (slots, 0.005)
    if fault is not None:
        fault(slices)


def make_bench(tmp: Path, cells: List[Dict], mixes: Dict[str, Dict]) -> Path:
    """A checkout-like root under ``tmp``: ``BENCHMARK.json`` with
    ``cells`` and rtbench's metrics, then ``rtbench/`` with the configs,
    the costs, the block families and the metric readers, and ``mixes``
    as traffic files."""
    root = tmp / "root"
    bench = root / "rtbench"
    for sub in ("configs", "costs", "families", "metrics"):
        shutil.copytree(HERE / sub, bench / sub)
    (bench / "traffic" / "mixes").mkdir(parents=True)
    for name, mix in mixes.items():
        (bench / "traffic" / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["workloads"] = cells
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
