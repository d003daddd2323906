"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root names each cell's configuration and
traffic. The configuration is ``configs/<config>.json``, its model's
block family ``families/<block_family>.py``, the traffic mix
``traffic/mixes/<traffic>.json``, each per-layer metric a reader
``metrics/<metric>.py`` and each kernel's costs ``costs/<kernel>.py``.
A later cell, configuration or metric is new files and new entries in
``BENCHMARK.json``; nothing here changes for it.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    end_to_end: List[Dict]  # the cell's end-to-end metric entries
    per_layer: List[Dict]  # the cell's per-layer metric entries
    root: Path = HERE.parent
    bench_dir: Path = HERE

    def config_spec(self) -> Dict:
        return load_json(self.bench_dir / "configs" / f"{self.config}.json")

    def traffic_mix(self) -> Dict:
        return load_json(self.bench_dir / "traffic" / "mixes" / f"{self.traffic}.json")


def load_json(path: Path) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Optional[Path] = None, bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, with the metrics it
    reports."""
    root = HERE.parent if root is None else Path(root)
    bench_dir = HERE if bench_dir is None else Path(bench_dir)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in reported]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), e2e, layer, root, bench_dir)


def _load_module(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: Optional[Path] = None) -> ModuleType:
    """The reader module of per-layer metric ``name``: ``read(ctx)``
    returns the metric's value, or None where it finds nothing to read."""
    bench_dir = HERE if bench_dir is None else Path(bench_dir)
    module = _load_module(bench_dir / "metrics" / f"{name}.py", f"rtbench_metric_{name}")
    if not callable(getattr(module, "read", None)):
        raise AttributeError(f"metric reader {name} has no read(ctx)")
    return module


FAMILY_PARTS = ("leaves", "trunk", "block_matmul_params", "mixer_flops")


def family(name: str, bench_dir: Optional[Path] = None) -> ModuleType:
    """The block family ``name`` (``families/<name>.py``): ``leaves(dims)``,
    the weights it draws; ``trunk(tree, tokens, dims, convert)``, its plain
    float32 reference up to the final norm; ``block_matmul_params(dims)``
    and ``mixer_flops(dims, ctx)``, its operations a token and layer."""
    bench_dir = HERE if bench_dir is None else Path(bench_dir)
    module = _load_module(bench_dir / "families" / f"{name}.py", f"rtbench_family_{name}")
    missing = [p for p in FAMILY_PARTS if not callable(getattr(module, p, None))]
    if missing:
        raise AttributeError(f"block family {name} lacks {missing}")
    return module


def kernel_costs(bench_dir: Optional[Path] = None) -> Dict[str, ModuleType]:
    """Every kernel's cost module by kernel name (``costs/<kernel>.py``,
    each with ``MATCH``, the device kernel names it covers,
    ``launch_shapes(job, model)`` and ``launch_cost(shape) -> (flops,
    bytes)``)."""
    bench_dir = HERE if bench_dir is None else Path(bench_dir)
    out = {}
    for path in sorted((bench_dir / "costs").glob("*.py")):
        if path.name.startswith("_"):
            continue
        module = _load_module(path, f"rtbench_costs_{path.stem}")
        if hasattr(module, "MATCH"):
            out[path.stem] = module
    return out


@dataclass
class Reading:
    """What a run hands each per-layer reader."""

    cell: Cell
    frames: list
    offered: int
    admitted: int
    counters: Dict  # the slice's Metrics counters over the window
    window: tuple  # (open, close) on the loop clock
    jobs: list  # JobRecord per dispatched job
    tracer: object = None
    trace: object = None  # devtrace.DeviceTrace of the traced window
    model: Dict = field(default_factory=dict)  # the port config's numbers and kernels
    family: object = None  # the model's block family (families/<name>.py)
