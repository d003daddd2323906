#!/usr/bin/env python3
"""Repeated and split measurements on one GPU, built on chip_smoke.py.

  python3 scripts/chip_measure.py faults 10   # phase `faults` 10 times
  python3 scripts/chip_measure.py bwd_split   # the D = 256 flash backward's
                                              # launches, timed apart
  python3 scripts/chip_measure.py wkv6_bwd    # the recurrences' backward
                                              # checks and times alone

``faults N`` builds the kernels once, then runs chip_smoke.py's phase
``faults`` N times in this process and prints one line per run (passed,
or the failure) and the count of passes. The phase's own log lines
(stall to quarantine ms, transitions) are printed as it runs.

``bwd_split`` times the flash backward at recurrentgemma-9b's local
attention shape (B = 1, S = 4096, H = 16, KV = 1, D = 256, window 2048,
bf16) and gemma3-12b's layout (KV = 8, window 1024) launch by launch:
``torch.profiler`` over 10 eager calls, CUDA time per kernel name
divided by the calls (chip_smoke.py's ``launch_split``), for the current
route and for ``previous_design``, after chip_smoke.py's check of the
kernel against its plain version.

``wkv6_bwd`` runs chip_smoke.py's checks and timings of the two
recurrences' backward kernels alone (``recurrence_backward_checks``:
wkv6_bwd at B = 8 and B = 1 in turns with its sequential design).

Prints the card's name and power limit first. Needs a GPU; exits
non-zero on any failure.
"""
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def faults(torch, runs: int) -> int:
    passed = 0
    for i in range(runs):
        try:
            with cs.Phase(f"faults run {i + 1}/{runs}"):
                cs.phase_faults(torch)
            passed += 1
            cs.log(f"faults run {i + 1}: passed")
        except Exception as e:  # noqa: BLE001 (each run's failure is the measurement)
            cs.log(f"faults run {i + 1}: FAILED {type(e).__name__}: {e}")
            traceback.print_exc()
    cs.log(f"faults: {passed} of {runs} runs passed")
    return 0 if passed == runs else 1


def bwd_split(torch) -> int:
    from repro_torch.kernels import flash_attention_bwd as fb

    gen = torch.Generator(device="cuda").manual_seed(19)
    cases = (("recurrentgemma", (1, cs.RGEMMA_TRAIN_SEQ, cs.RGEMMA_TRAIN_SEQ, 16, 1, 256, True),
              cs.RGEMMA_WINDOW),
             ("gemma3-12b", (1, cs.GEMMA3_SEQ, cs.GEMMA3_SEQ, 16, 8, 256, True),
              cs.GEMMA3_WINDOW))
    for label, shape, window in cases:
        inp, kw, err = cs.bwd_case(torch, gen, torch.bfloat16, *shape, window=window)
        q = inp[0]
        inputs = cs.copies(inp, (2 * q.numel() + 2 * inp[1].numel() + inp[3].numel())
                           * q.element_size())
        cs.log(f"flash bwd {label} window shape {shape} window {window}: max_abs_err {err:.3e}; "
               f"route {fb.route(q.dtype, q.shape[-1])}")
        designs = (("route", lambda *x: fb.flash_attention_bwd(*x, **kw)),
                   ("previous_design", lambda *x: fb.previous_design(*x, **kw)))
        for name, fn in designs:
            parts = cs.launch_split(torch, fn, inputs)
            cs.log(f"{name}: {sum(parts.values()):.4f} ms a call (torch.profiler, eager): "
                   + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
        del inp, inputs
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_measure: needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cs.log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    _build.build()
    what = sys.argv[1] if len(sys.argv) > 1 else "faults"
    if what == "faults":
        return faults(torch, int(sys.argv[2]) if len(sys.argv) > 2 else 10)
    if what == "bwd_split":
        return bwd_split(torch)
    if what == "wkv6_bwd":
        cs.recurrence_backward_checks(torch, {})
        return 0
    raise SystemExit(f"chip_measure: unknown measurement {what!r}")


if __name__ == "__main__":
    sys.exit(main())
