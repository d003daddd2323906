#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py            # one GPU, no arguments

Phases (each prints one line with its seconds; any failure exits non-zero):

1. device  — requires CUDA, prints the card's name and power limit,
             turns TF32 off for matmuls and cuDNN.
2. build   — builds both CUDA kernels from src/repro_torch/kernels/csrc
             with nvcc for sm_90a (one nvcc per source, in parallel).
3. kernels — holds each kernel against its plain PyTorch version at the
             main path's shapes, in bf16 (2e-2) and float32 (2e-5), and
             times kernel, plain version and SDPA (the yardstick).
4. model   — granite-3-2b at full width, 2 layers, float32: prefill and
             decode logits on the kernel path (default impl) against
             impl="dense", at 2e-3.
5. serve   — the main path: full granite-3-2b (40 layers, bf16, random
             weights from a seed) served by DeepRT through
             build_live_scheduler, one prefill and one decode category;
             checks admission, conservation, zero decode compiles after
             warm-up, and that both kernels launched while serving.

Before the last line it prints the nvidia-smi line and one JSON object
with a row per kernel; the last line is the device record.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MID = "granite-3-2b"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 FMA
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
L2_BYTES = 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"--- phase {self.name}")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        log(f"phase {self.name}: {status} in {dt:.3f} s")
        return False  # never swallow a failure


def time_ms(fn, inputs, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call of ``fn(*inp)`` over ``iters`` calls that
    cycle through ``inputs`` (copies whose total exceeds the L2 cache, so
    each call finds its operands cold, as the model's layers do)."""
    import torch

    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def n_copies(nbytes: int) -> int:
    return max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def assert_close(name: str, got, want, tol: float) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    bound = tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > bound).any()):
        raise AssertionError(
            f"{name}: max abs err {err.max().item():.3e} beyond tol {tol}"
        )
    return float(err.max().item())


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------


def decode_inputs(torch, b, s, h, kv, d, dtype, gen, *, cursors, active=None,
                  ring=False):
    dev = "cuda"
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dtype)
    ck = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
    cv = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
    cursor = torch.tensor(cursors, dtype=torch.int32, device=dev)
    if ring:
        # Shuffled slot positions within [cursor - s + 1, cursor], with
        # -1 sentinels for slots never written.
        pos = torch.stack([
            torch.randperm(s, generator=gen, device=dev) + (c - s + 1) for c in cursors
        ]).to(torch.int32)
        holes = torch.rand((b, s), generator=gen, device=dev) < 0.2
        pos = torch.where(holes, torch.full_like(pos, -1), pos)
        valid = pos >= 0
    else:
        pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
        valid = pos <= cursor[:, None]
    act = None if active is None else torch.tensor(active, dtype=torch.bool, device=dev)
    return q, ck, cv, cursor, pos.contiguous(), valid.contiguous(), act


def live_slots(cursor, pos, valid, active, window) -> int:
    """Cache slots these inputs attend to: the K/V rows the work needs."""
    mask = (pos <= cursor[:, None]) & valid
    if window is not None:
        mask &= pos > cursor[:, None] - window
    if active is not None:
        mask &= active[:, None]
    return int(mask.sum())


def phase_kernels(torch, report):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(1234)
    h, kv, d = 32, 8, 64
    g = h // kv

    # ----- decode attention -------------------------------------------
    b, s = 8, 2048
    spread = [s - 1, 1500, 1023, 700, 300, 64, 5, 0]
    cases = [
        ("all live, full cache", dict(cursors=[s - 1] * b), None),
        ("cursors spread, dead rows", dict(cursors=spread,
                                           active=[1, 1, 0, 1, 1, 0, 1, 1]), None),
        ("window 300", dict(cursors=spread), 300),
        ("ring positions, -1 sentinels", dict(cursors=[4000, 3000, 2500, 2100, 2047,
                                                       5000, 2200, 9000], ring=True), 700),
    ]
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for label, kw, window in cases:
            q, ck, cv, cur, pos, valid, act = decode_inputs(
                torch, b, s, h, kv, d, dtype, gen, **kw)
            got = dk.decode_attention(q, ck, cv, cur, pos, valid, act, window=window)
            want = dk.decode_attention_plain(q, ck, cv, cur, pos, valid, act, window=window)
            torch.cuda.synchronize()
            err = assert_close(f"decode {label} {dtype_name}", got, want, TOL[dtype_name])
            if act is not None:
                dead = ~act
                if bool(got[dead].float().abs().max() != 0):
                    raise AssertionError("decode: a dead row is not exact 0")
            log(f"decode {dtype_name} B={b} S={s} H={h} KV={kv} D={d} [{label}]: "
                f"max_abs_err={err:.3e}")
        # A head group too large for one block's shared memory (G=64, D=256).
        q, ck, cv, cur, pos, valid, act = decode_inputs(
            torch, 2, 300, 64, 1, 256, dtype, gen, cursors=[299, 150])
        got = dk.decode_attention(q, ck, cv, cur, pos, valid, act)
        want = dk.decode_attention_plain(q, ck, cv, cur, pos, valid, act)
        torch.cuda.synchronize()
        err = assert_close(f"decode split group {dtype_name}", got, want, TOL[dtype_name])
        log(f"decode {dtype_name} B=2 S=300 H=64 KV=1 D=256 [split head group]: "
            f"max_abs_err={err:.3e}")
    # Timing at the served shape: all rows live, cursor at the cache end
    # (the profiled worst case of the decode step), bf16.
    dtype = torch.bfloat16
    base = decode_inputs(torch, b, s, h, kv, d, dtype, gen, cursors=[s - 1] * b)
    q, ck, cv, cur, pos, valid, act = base
    per_copy = 2 * ck.numel() * ck.element_size()
    inputs = [base] + [
        (q, ck.clone(), cv.clone(), cur, pos, valid, act)
        for _ in range(n_copies(per_copy) - 1)
    ]
    run_k = lambda *a: dk.decode_attention(*a)
    run_p = lambda *a: dk.decode_attention_plain(*a)
    got = run_k(*base)
    err = assert_close("decode timed case", got, run_p(*base), TOL["bfloat16"])
    ms = time_ms(run_k, inputs)
    plain_ms = time_ms(run_p, inputs, iters=5, warmup=1)
    # SDPA yardstick on the same inputs, laid out (B, H, S, D) beforehand.
    lib_inputs = []
    for (q_, k_, v_, c_, p_, va_, _a) in inputs:
        mask = ((p_ <= c_[:, None]) & va_)[:, None, None, :]
        lib_inputs.append((q_.transpose(1, 2).contiguous(), k_.transpose(1, 2).contiguous(),
                           v_.transpose(1, 2).contiguous(), mask))
    lib = lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=m_, enable_gqa=True)
    library_ms = time_ms(lib, lib_inputs)
    n_live = live_slots(cur, pos, valid, act, None)
    esz = ck.element_size()
    nbytes = (q.numel() * esz * 2  # q read, out written
              + 2 * n_live * kv * d * esz  # K and V of the live slots
              + b * 4 + b * s * 4 + b * s)  # cursor, positions, validity
    flops = 4 * n_live * kv * g * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    report.setdefault("decode_attention", {}).update(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:145",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms,
        shape=f"B={b} S={s} H={h} KV={kv} D={d} bf16, all rows live, cursor S-1",
    )
    log(f"decode timed B={b} S={s} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes} bytes, {flops} flops)")

    # ----- flash attention --------------------------------------------
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for b in (1, 8):
            for s in (512, 509):
                for window in (None, 128):
                    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
                    k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
                    v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
                    got = fk.flash_attention(q, k, v, causal=True, window=window)
                    want = fk.flash_attention_plain(q, k, v, causal=True, window=window)
                    torch.cuda.synchronize()
                    err = assert_close(
                        f"flash B={b} S={s} window={window} {dtype_name}",
                        got, want, TOL[dtype_name])
                    log(f"flash {dtype_name} B={b} S={s} H={h} KV={kv} D={d} causal "
                        f"window={window}: max_abs_err={err:.3e}")
    # Timing at the served prefill shape: the largest bucket, causal, bf16.
    b, s, dtype = 8, 512, torch.bfloat16
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
    per_copy = (q.numel() + 2 * k.numel()) * q.element_size()
    inputs = [(q, k, v)] + [(q.clone(), k.clone(), v.clone())
                            for _ in range(n_copies(per_copy) - 1)]
    run_k = lambda q_, k_, v_: fk.flash_attention(q_, k_, v_, causal=True)
    run_p = lambda q_, k_, v_: fk.flash_attention_plain(q_, k_, v_, causal=True)
    err = assert_close("flash timed case", run_k(q, k, v), run_p(q, k, v), TOL["bfloat16"])
    ms = time_ms(run_k, inputs)
    plain_ms = time_ms(run_p, inputs, iters=5, warmup=1)
    lib_inputs = [tuple(t.transpose(1, 2).contiguous() for t in inp) for inp in inputs]
    lib = lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, is_causal=True, enable_gqa=True)
    library_ms = time_ms(lib, lib_inputs)
    esz = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * esz  # q, k, v read; out written
    pairs = s * (s + 1) // 2  # causal (query, key) pairs per (b, h)
    flops = 4 * b * h * d * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    report.setdefault("flash_attention", {}).update(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:148",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms,
        shape=f"B={b} S={s} H={h} KV={kv} D={d} bf16 causal",
    )
    log(f"flash timed B={b} S={s} bf16 causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes} bytes, {flops} flops)")
    log(f"launch counters after the kernels phase: {ops.launch_counts()}")


def phase_model(torch):
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_for

    cfg = get_config(MID, n_layers=2, param_dtype="float32")
    m_k = model_for(cfg)
    m_d = model_for(dataclasses.replace(cfg, impl="dense"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = m_k.init(gen, device="cuda")
    b, s = 2, 129
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    with torch.no_grad():
        lk, _ = m_k.forward(params, toks)
        ld, _ = m_d.forward(params, toks)
        err = assert_close("model forward logits", lk, ld, 2e-3)
        log(f"model forward B={b} S={s} f32: logits {tuple(lk.shape)}, max_abs_err={err:.3e}")
        max_len, n_pre, n_dec = 160, 64, 4
        caches = [m.init_cache(b, max_len, device="cuda") for m in (m_k, m_d)]
        outs = []
        for m, cache in zip((m_k, m_d), caches):
            lg, _ = m.prefill(params, cache, toks[:, :n_pre])
            steps = [lg]
            for t in range(n_dec):
                cur = torch.full((b,), n_pre + t, dtype=torch.int32, device="cuda")
                lg, _ = m.decode_step(params, cache, toks[:, n_pre + t], cur)
                steps.append(lg)
            outs.append(torch.stack(steps))
        err = assert_close("model prefill+decode logits", outs[0], outs[1], 2e-3)
        # Decode must also agree with the full forward at those positions.
        ref = ld[:, n_pre:n_pre + n_dec].transpose(0, 1)
        err2 = assert_close("decode vs forward", outs[0][1:], ref, 2e-3)
    log(f"model prefill {n_pre} + {n_dec} decode steps: kernel vs dense max_abs_err={err:.3e}, "
        f"decode vs forward {err2:.3e}")


def phase_serve(torch, report):
    from repro_torch.configs.registry import get_config
    from repro_torch.core import Category, Request
    from repro_torch.kernels import ops
    from repro_torch.serving.batcher_bridge import build_live_scheduler
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config(MID)
    pre_seq, dec_seq = 512, 2048
    cats = [(MID, (pre_seq,), "prefill"), (MID, (dec_seq,), "decode")]
    t0 = time.perf_counter()
    engine = InferenceEngine({MID: cfg}, seed=0, max_slots=8, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(engine.params[MID]))
    log(f"engine: {n_params} parameters ({cfg.param_dtype}) made on the card in "
        f"{time.perf_counter() - t0:.3f} s; arena {engine.arena_nbytes(MID, dec_seq)} bytes")

    ops.reset_launch_counts()
    sched, engine, table = build_live_scheduler(
        {MID: cfg}, cats, batch_sizes=(1, 2, 4, 8), engine=engine)
    profiling_launches = ops.launch_counts()
    w_dec = table.wcet(MID, (dec_seq,), engine.max_slots)
    w_pre = {bs: table.wcet(MID, (pre_seq,), bs) for bs in (1, 2, 4, 8)}
    log(f"profiled WCET (p99 of 5 runs): decode seq {dec_seq} x {engine.max_slots} slots "
        f"{w_dec * 1e3:.3f} ms; prefill seq {pre_seq} by batch "
        + ", ".join(f"{bs}: {w * 1e3:.3f} ms" for bs, w in w_pre.items()))
    log(f"launches during profiling: {profiling_launches}")

    # Periods and deadlines from the profiled table: every stream's
    # deadline is 12x the cost of one decode step plus the largest
    # prefill, its period half that (about one frame per window).
    deadline = 12.0 * (w_dec + w_pre[8])
    period = deadline / 2
    frames = 20
    start = sched.loop.now + 0.05
    reqs = (
        [Request(Category(MID, (dec_seq,)), period=period, relative_deadline=deadline,
                 n_frames=frames, start_time=start) for _ in range(4)]
        + [Request(Category(MID, (pre_seq,)), period=period, relative_deadline=deadline,
                   n_frames=frames, start_time=start) for _ in range(2)]
    )
    admitted = {"decode": 0, "prefill": 0}
    for r in reqs:
        kind = "decode" if r.category.shape_key == (dec_seq,) else "prefill"
        res = sched.submit_request(r)
        admitted[kind] += int(res.admitted)
        log(f"request {kind} period={period * 1e3:.3f} ms deadline={deadline * 1e3:.3f} ms: "
            f"{'ADMIT' if res.admitted else 'REJECT'} (phase {res.phase}, U={res.utilization:.3f})")
    if admitted["decode"] < 1 or admitted["prefill"] < 1:
        raise AssertionError(f"admission: {admitted}; need >= 1 of each kind")

    ops.reset_launch_counts()
    t_run = time.perf_counter()
    m = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    serving_launches = ops.launch_counts()
    log(f"launches during serving: {serving_launches}")
    ingested = m.ingested_frames
    log(f"served in {wall:.3f} s: completed={m.completed_frames} missed={m.missed_frames} "
        f"dropped={m.dropped_frames} lost={m.lost_frames} ingested={ingested} "
        f"jobs={m.job_count} mean_batch={m.mean_batch:.3f} "
        f"miss_rate={m.miss_rate:.4f} p99_latency={m.latency_percentile(0.99) * 1e3:.3f} ms "
        f"throughput={m.throughput:.3f} frames/s decode_compiles={engine.stats['decode_compiles']}")
    if m.completed_frames < 1:
        raise AssertionError("no frame completed")
    if m.completed_frames + m.dropped_frames + m.lost_frames != ingested:
        raise AssertionError("conservation: completed + dropped + lost != ingested")
    if engine.stats["decode_compiles"] != 0:
        raise AssertionError(f"decode_compiles = {engine.stats['decode_compiles']} after warm-up")
    for name, n in serving_launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched while serving")
        report.setdefault(name, {})["launches"] = n

    # The served step's outputs are well formed.
    logits = engine.dispatch(MID, (dec_seq,), engine.max_slots, "decode").wait()
    nxt = engine.dispatch(MID, (pre_seq,), 8, "prefill").wait()
    if tuple(logits.shape) != (engine.max_slots, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"decode logits malformed: {tuple(logits.shape)}")
    if tuple(nxt.shape) != (8,) or not bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()):
        raise AssertionError(f"prefill tokens malformed: {nxt}")
    report["_serve"] = dict(
        wcet_decode_ms=w_dec * 1e3, wcet_prefill_ms={b: w * 1e3 for b, w in w_pre.items()},
        miss_rate=m.miss_rate, p99_latency_ms=m.latency_percentile(0.99) * 1e3,
        throughput=m.throughput, completed=m.completed_frames, ingested=ingested,
        admitted=admitted, launches_serving=serving_launches,
        launches_profiling=profiling_launches, peak_mem_bytes=torch.cuda.max_memory_allocated(),
    )


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build  # fails outside the repository

    report: dict = {}
    with Phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; {smi}")
    with Phase("build"):
        for name, path in _build.build().items():
            text = _build.log_path(name).read_text() if _build.log_path(name).exists() else ""
            stats = [ln.strip() for ln in text.splitlines()
                     if "registers" in ln or "spill" in ln]
            log(f"built {name}: {path.name}")
            for ln in stats:
                log(f"  ptxas {ln}")
    with Phase("kernels"):
        phase_kernels(torch, report)
    with Phase("model"):
        phase_model(torch)
    with Phase("serve"):
        phase_serve(torch, report)
        log("served: " + json.dumps(report["_serve"], sort_keys=True))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [{k: report[n][k] for k in keys} for n in ("decode_attention", "flash_attention")]
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
