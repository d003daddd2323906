"""Roofline analysis of a counted call (``repro.roofline.analysis`` in the
port).

Three terms per (arch x shape x mesh), all in seconds (idealized):

    compute    = FLOPs_per_rank / peak FLOP/s of one card
    memory     = HBM bytes_per_rank / HBM bytes/s of one card
    collective = collective bytes_per_rank / link bytes/s of one card

The counts come from ``op_cost.OpCost`` (FLOPs, ideal-fusion bytes,
collectives by kind), taken on one rank of the dry run's fake group.
As in the reference, the compute term takes the larger of the ideal
(global FLOPs / ranks) and this rank's own work (local ops, which charge
replicated compute to every rank); the memory term uses the ideal bytes
(global / ranks), with this rank's unfused traffic (every local op's
operands and results, what eager kernels move) beside it as the upper
bound.

Also reported: MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) and the
ratio MODEL_FLOPS / FLOPs, how much of the counted compute is "useful"
(it catches remat recompute and dispatch waste). For decode steps D =
batch tokens (one step), and the 2x backward factor is absent.

Hardware constants: one NVIDIA H100 SXM (H100 80GB HBM3), from NVIDIA's
H100 Tensor Core GPU data sheet, dense rates without sparsity, at the
700 W power limit:

- ``PEAK_FLOPS`` 989e12: bf16 Tensor Core FLOP/s (the rate ``PERF.md``
  §6 uses for kernel bounds);
- ``HBM_BW`` 3.35e12: HBM3 bytes/s (likewise);
- ``LINK_BW`` 450e9: NVLink 4's bytes/s in one direction (900 GB/s
  total over 18 links, both directions).

They are reckoned limits, not measurements; a card set below 700 W runs
slower under load.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


@dataclasses.dataclass
class RooflineReport:
    flops: float  # per rank
    hbm_bytes: float  # per rank (ideal-fusion lower bound)
    coll_bytes: float  # per rank, total over collective kinds
    coll_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: Optional[float] = None
    hbm_bytes_upper: Optional[float] = None  # unfused eager traffic

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / self.flops

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_breakdown": self.coll_breakdown,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_per_device": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "hbm_bytes_upper_per_device": self.hbm_bytes_upper,
        }


def analyze(
    counts: dict,
    model_flops_global: Optional[float] = None,
    n_devices: int = 1,
) -> RooflineReport:
    """The three terms from ``op_cost`` counts of one rank (``OpCost.result()``)."""
    ideal_flops = counts["flops_global"] / n_devices
    flops = max(counts["flops_local"], ideal_flops)
    hbm = counts["bytes_global"] / n_devices
    coll = {k: float(v) for k, v in counts["collectives"]["bytes"].items()}
    coll_total = float(sum(coll.values()))
    return RooflineReport(
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=coll_total,
        coll_breakdown=coll,
        compute_s=flops / PEAK_FLOPS,
        memory_s=hbm / HBM_BW,
        collective_s=coll_total / LINK_BW,
        model_flops=(model_flops_global / n_devices if model_flops_global else None),
        hbm_bytes_upper=counts.get("bytes_local_all_ops"),
    )


def model_flops_for(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """6·N_active·D for train (fwd+bwd), 2·N_active·D for inference."""
    n_active = cfg.active_param_count_estimate()
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if shape_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * global_batch


def roofline_table(cells) -> Dict[str, list]:
    """The table ``benchmarks/roofline_report.py`` writes, from dry-run cells
    (the JSON objects ``launch/dryrun.py`` writes): ``{"header": [...],
    "rows": [...], "best_header": [...], "best_rows": [...], "summary":
    [...]}``. A failed cell is a FAIL row with its error."""
    rows = []
    for c in cells:
        if not c.get("ok"):
            rows.append([c["arch"], c["shape"], c["mesh"], c.get("opt", "baseline"), "FAIL",
                         "", "", "", "", "", "", c.get("error", "")[:80]])
            continue
        r = c["roofline"]
        mem = c.get("memory_analysis", {})
        gb = (mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0)) / 1e9
        rows.append([
            c["arch"], c["shape"], c["mesh"], c.get("opt", "baseline"), "ok",
            f"{r['compute_s']:.3e}", f"{r['memory_s']:.3e}", f"{r['collective_s']:.3e}",
            r["dominant"],
            f"{r['useful_flops_ratio']:.3f}" if r.get("useful_flops_ratio") else "",
            f"{gb:.2f}", "",
        ])
    best: Dict[tuple, dict] = {}
    for c in cells:
        if not c.get("ok"):
            continue
        r = c["roofline"]
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        entry = best.setdefault((c["arch"], c["shape"], c["mesh"]), {})
        if c.get("opt", "baseline") == "baseline":
            entry["baseline"] = bound
        if "best" not in entry or bound < entry["best"][0]:
            entry["best"] = (bound, c.get("opt", "baseline"), r["dominant"])
    best_rows = []
    for (a, s, m), e in sorted(best.items()):
        base = e.get("baseline")
        b, opt, dom = e["best"]
        speedup = (base / b) if base and b > 0 else 1.0
        best_rows.append([a, s, m, f"{base:.3e}" if base else "", f"{b:.3e}", opt, dom,
                          f"{speedup:.1f}"])
    n_ok = sum(1 for r in rows if r[4] == "ok")
    doms: Dict[str, int] = {}
    for r in rows:
        if r[4] == "ok":
            doms[r[8]] = doms.get(r[8], 0) + 1
    summary = [f"roofline,cells_ok,{n_ok}", f"roofline,cells_fail,{len(rows) - n_ok}",
               f"roofline,dominant_breakdown,{doms}"]
    single = [r for r in best_rows if r[2] == "16x16" and r[3]]
    if single:
        import statistics

        geo = statistics.geometric_mean([max(float(r[7]), 1e-9) for r in single])
        summary.append(f"roofline,geomean_speedup_single_pod,{geo:.2f}")
    return {
        "header": ["arch", "shape", "mesh", "opt", "status", "compute_s", "memory_s",
                   "collective_s", "dominant", "useful_flops_ratio",
                   "per_device_arg+temp_GB", "note"],
        "rows": rows,
        "best_header": ["arch", "shape", "mesh", "baseline_bound_s", "best_bound_s",
                        "best_variant", "dominant_after", "speedup_x"],
        "best_rows": best_rows,
        "summary": summary,
    }


def load_cells(directory: str, pattern: str = "*.json") -> list:
    """The dry-run cells under ``directory``, by file name."""
    import glob
    import json
    import os

    cells = []
    for path in sorted(glob.glob(os.path.join(directory, pattern))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells
