"""Readings that set a cell's limits: the program's and the control's.

    python3 rtbench/tools/control.py --workload granite.chat --seconds 8 --seeds 11,12,13

For each seed it runs the cell's harness with a short window at the
cell's own load and reads, on the same sample of served prompts and
decode steps, the program's gaps (the lower readings) and the control's:
the reference with its weights rounded through float8 e4m3 put in the
program's place, the gap of the token it puts first (the upper
readings). One JSON line per seed.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = harness.run(cell, seed, args.seconds, False, "cuda", t0, control=True)
        ex = out["extra"]
        print(json.dumps({"seed": seed, "numbers": ex["numbers"], "correct": out["line"]["correct"],
                          "summary": ex["summary"],
                          "check_s": ex["check_s"], "shrunk_jobs": ex["shrunk_jobs"],
                          "gap_frames": ex["gap_frames"],
                          "wall_s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
