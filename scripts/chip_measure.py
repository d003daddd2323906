#!/usr/bin/env python3
"""Repeated and split measurements on one GPU, built on chip_smoke.py.

  python3 scripts/chip_measure.py faults 10   # phase `faults` 10 times
  python3 scripts/chip_measure.py bwd_split   # the D = 256 flash backward's
                                              # launches, timed apart
  python3 scripts/chip_measure.py wkv6_bwd    # the recurrences' backward
                                              # checks and times alone
  python3 scripts/chip_measure.py rglru       # rglru_scan / rglru_bwd: checks,
                                              # times, both routes by shape
  python3 scripts/chip_measure.py sharding    # chip_smoke.py's phase sharding
  python3 scripts/chip_measure.py dryrun OUT  # every dry-run cell, both meshes,
                                              # JSON under OUT, the table printed
  python3 scripts/chip_measure.py zoo [ARCH..]  # phases serve_zoo and
                                              # multitenant_driver alone
  python3 scripts/chip_measure.py hybrid      # chip_smoke.py's phase hybrid
                                              # (granite-4.0-h-micro) alone

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

``rglru`` runs chip_smoke.py's checks and timings of rglru_scan and
rglru_bwd alone (``rglru_kernel_checks``, ``rglru_bwd_checks``), then
times both routes of each at B = 1, 2, 4, 8 and S = 512, 4096 (D = 4096,
float32, no states; the chunked route with ``plan_chunks``' plan, forced
where the rule picks streaming) in turns, each chunk length of
``CHUNKS`` at the training shape, and recurrentgemma-9b's 12-layer train
step (chip_smoke.py's ``train_full_width``) with the route rule and with
every call streaming, in turns (route, streaming, streaming, route).

``sharding`` runs chip_smoke.py's phase ``sharding`` alone: the host
mesh, granite-3-2b's meshed train steps against unmeshed ones,
mixtral-8x7b's local MoE path against its global one, two dry-run
cells.

``dryrun OUT`` runs ``python -m repro_torch.launch.dryrun`` on every
arch x applicable shape at ``--mesh both`` and on llama4-maverick's
``decode_32k`` with ``--opt moe_local``: one subprocess a cell, the
archs' cells in parallel (one worker per arch, the GPU hidden: the cells
run on the host's CPU over fake tensors), each cell under a time limit
(a cell cut by it is reported as such), and prints
``roofline.analysis.roofline_table`` over the JSON files it wrote. It
needs no GPU (it does not build the kernels).

``zoo`` runs chip_smoke.py's phases ``serve_zoo`` (the archs named, or
all four of ``ZOO_LAYERS``) and ``multitenant_driver`` (only when no arch
is named) and prints the attention kernels' timed shape records as one
JSON line.

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


def _routes(torch, fwd: bool, b: int, s: int, chunk=None):
    """(chunked ms, streaming ms) of rglru_scan (``fwd``) or rglru_bwd at
    (b, s, 4096) float32, in turns; ``chunk`` overrides the plan's."""
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels import rglru_bwd as rb
    from repro_torch.kernels.decode_attention import _sm_count

    gen = torch.Generator(device="cuda").manual_seed(7)
    d = 4096
    a, x, _ = cs.rglru_inputs(torch, gen, b, s, d, torch.float32, False)
    l_, n = (rk.plan_chunks(b, s, d, _sm_count(a.device)) if chunk is None
             else (chunk, -(-s // chunk)))
    if fwd:
        base = (a, x)
        chunked = lambda *t: rk._launch(*t, None, (l_, n))  # noqa: E731
        stream = lambda *t: rk._launch(*t, None, None)  # noqa: E731
    else:
        h = rk.previous_design(a, x)[0]
        base = (a, h, x)  # x stands in for dh
        chunked = lambda *t: rb._launch(*t, None, None, (l_, n))  # noqa: E731
        stream = lambda *t: rb._launch(*t, None, None, None)  # noqa: E731
    inputs = cs.copies(base, len(base) * a.numel() * 4)
    out = cs.in_turns(chunked, stream, inputs)
    del a, x, base, inputs
    return out, (l_, n)


def rglru(torch) -> int:
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels.decode_attention import _sm_count

    report: dict = {}
    cs.rglru_kernel_checks(torch, report)
    cs.rglru_bwd_checks(torch, report)
    sms = _sm_count(torch.device("cuda"))
    for fwd, name in ((True, "rglru_scan"), (False, "rglru_bwd")):
        for s in (512, cs.RGEMMA_TRAIN_SEQ):
            for b in (1, 2, 4, 8):
                (c_ms, s_ms), (l_, n) = _routes(torch, fwd, b, s)
                rule = "chunked" if rk.uses_chunked(b, s, 4096, sms) else "streaming"
                cs.log(f"{name} routes B={b} S={s} D=4096 f32: chunked (L={l_}, n={n}) "
                       f"{c_ms:.4f} ms, streaming {s_ms:.4f} ms (in turns); rule: {rule}")
        for chunk in rk.CHUNKS:
            (c_ms, s_ms), _ = _routes(torch, fwd, 1, cs.RGEMMA_TRAIN_SEQ, chunk)
            cs.log(f"{name} chunk length {chunk} at B=1 S={cs.RGEMMA_TRAIN_SEQ}: chunked "
                   f"{c_ms:.4f} ms, streaming {s_ms:.4f} ms (in turns)")
    steps = {"route": [], "streaming": []}
    rule = rk.uses_chunked
    for arm in ("route", "streaming", "streaming", "route"):
        rk.uses_chunked = rule if arm == "route" else (lambda *a: False)
        try:
            out = {"rglru_bwd": {}}
            cs.train_full_width(torch, out, cs.RGEMMA, cs.RGEMMA_TRAIN_LAYERS,
                                cs.RGEMMA_TRAIN_BATCH, cs.RGEMMA_TRAIN_SEQ)
        finally:
            rk.uses_chunked = rule
        steps[arm].append(out["train"][cs.RGEMMA]["median_step_ms"])
    cs.log("recurrentgemma-9b x12 train step median ms (in turns): " + ", ".join(
        f"{arm} {v}" for arm, v in steps.items()))
    return 0


DRYRUN_CELL_S = 900


def dryrun_all(out: str) -> int:
    """Every dry-run cell in subprocesses, one worker per arch."""
    import json
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs.registry import ARCHS, applicable_shapes, get_config
    from repro_torch.roofline import analysis

    if shutil.which("nvidia-smi"):
        cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip())
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    jobs = {arch: [["--arch", arch, "--shape", shape, "--mesh", "both"]
                   for shape in applicable_shapes(get_config(arch))] for arch in ARCHS}
    jobs["moe_local"] = [["--arch", "llama4-maverick-400b-a17b", "--shape", "decode_32k",
                          "--mesh", "both", "--opt", "moe_local"]]

    def run(cells):
        lines = []
        for args in cells:
            try:
                r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                                    "--out", out], capture_output=True, text=True, env=env,
                                   cwd=str(ROOT), timeout=DRYRUN_CELL_S)
                lines += [ln for ln in r.stdout.splitlines() if ln.startswith(("OK", "FAIL"))]
            except subprocess.TimeoutExpired:
                lines.append(f"CUT  {' '.join(args)}: past {DRYRUN_CELL_S} s")
        return lines

    with ThreadPoolExecutor(len(jobs)) as pool:
        for lines in pool.map(run, jobs.values()):
            for ln in lines:
                cs.log(ln)
    cells = analysis.load_cells(out)
    table = analysis.roofline_table(cells)
    cs.log(",".join(table["header"]))
    for row in table["rows"]:
        cs.log(",".join(str(x) for x in row))
    for line in table["summary"]:
        cs.log(line)
    cs.log(json.dumps([{k: c.get(k) for k in ("arch", "shape", "mesh", "opt", "ok", "run_s")}
                       for c in cells]))
    return 0


def main() -> int:
    import os

    if len(sys.argv) > 2 and sys.argv[1] == "dryrun":
        return dryrun_all(sys.argv[2])

    # cuBLAS's deterministic workspace (phase sharding runs deterministic).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if what == "rglru":
        return rglru(torch)
    if what == "hybrid":
        import json

        report: dict = {}
        with cs.Phase("hybrid"):
            cs.phase_hybrid(torch, report)
        print(json.dumps(report, default=str))
        return 0
    if what == "zoo":
        import json

        report: dict = {}
        archs = sys.argv[2:]
        if archs:
            cs.ZOO_LAYERS = {a: cs.ZOO_LAYERS[a] for a in archs}
        with cs.Phase("serve_zoo"):
            cs.phase_serve_zoo(torch, report)
        if not archs:
            with cs.Phase("multitenant_driver"):
                cs.phase_multitenant_driver(torch, report)
        print(json.dumps({n: r.get("shapes", []) for n, r in report.items()}))
        return 0
    if what == "sharding":
        with cs.Phase("sharding"):
            cs.phase_sharding(torch, {})
        return 0
    raise SystemExit(f"chip_measure: unknown measurement {what!r}")


if __name__ == "__main__":
    sys.exit(main())
