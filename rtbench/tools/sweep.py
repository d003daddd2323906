"""The knee of a cell: how many streams admission takes at each offer.

    python3 rtbench/tools/sweep.py --workload granite.chat --seed 1 --seconds 6 \
        --offer prompt512=4,8,16,24,32

For each offer (the class's count; other classes as the mix has them)
or, with ``--scale``, each multiple of every class's count, it runs the
cell's harness once with a short window and prints one JSON line: the
streams admitted per class, the goodput, the tail and the failures.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch

    from rtbench import harness, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--offer", default=None, help="class=n1,n2,...")
    ap.add_argument("--scale", default=None, help="f1,f2,...: every class's count times f")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    base = cell.traffic_mix()
    offers = []
    if args.offer:
        cls, counts = args.offer.split("=")
        for n in counts.split(","):
            mix = copy.deepcopy(base)
            next(c for c in mix["classes"] if c["name"] == cls)["count"] = int(n)
            offers.append((f"{cls}={n}", mix))
    for f in (args.scale.split(",") if args.scale else []):
        mix = copy.deepcopy(base)
        for c in mix["classes"]:
            c["count"] = max(1, round(c["count"] * float(f)))
        offers.append((f"x{f}", mix))
    for label, mix in offers:
        t0 = time.time()
        out = harness.run(cell, args.seed, args.seconds, False, "cuda", t0, mix=mix)
        ex = out["extra"]
        print(json.dumps({
            "offer": label, "counts": {c["name"]: c["count"] for c in mix["classes"]},
            "admitted_by_class": ex["admitted_by_class"], "by_class": ex["by_class"],
            "penalties": ex["penalties"], "e2e": ex["e2e"],
            "summary": ex["summary"],
            "correct": out["line"]["correct"], "numbers": ex["numbers"], "wcet": ex["wcet"],
            "shape_changes": ex["shape_changes"], "shrunk_jobs": ex["shrunk_jobs"],
            "memory_peak_bytes": out["line"]["device"]["memory_peak_bytes"],
            "memory_reserved_bytes": ex["memory_reserved_bytes"], "wall_s": time.time() - t0,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
