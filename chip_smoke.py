#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py            # one GPU, no arguments

Phases (each prints one line with its seconds; any failure exits non-zero):

1. device  — requires CUDA, prints the card's name and power limit,
             turns TF32 off for matmuls and cuDNN.
2. build   — builds the four CUDA kernels from src/repro_torch/kernels/csrc
             with nvcc for sm_90a (one nvcc per source, in parallel),
             prints ptxas' register and spill lines and, from
             `cuobjdump -sass`, each library's count of tensor-core
             (HGMMA, HMMA) and async-copy (UTMALDG, LDGSTS) instructions;
             fails unless flash_attention has HGMMA, decode_attention and
             wkv6 (its chunked design) HMMA.
3. kernels — holds each kernel against its plain PyTorch version at the
             main path's shapes, in bf16 (2e-2) and float32 (2e-5): the
             two attention kernels at granite-3-2b's and recurrentgemma-
             9b's shapes (decode also for bit-identical repeats), wkv6 at
             rwkv6-1.6b's (both designs: chunked for bf16 from 64 steps,
             sequential for float32 and decode's single step; the chunked
             one also at extreme decays, bit-identical repeats),
             rglru_scan at recurrentgemma-9b's; times kernel, plain
             version and, for attention, SDPA (the yardstick), and the
             previous design in turns with the kernel (new, old, old,
             new): bf16 attention, and wkv6 at (B, S) = (8, 512), (1, 512)
             and (8, 1) against its sequential design. Kernel, previous
             and SDPA times are device times (a CUDA graph of 20 calls,
             replayed); the plain versions are timed eagerly, and so is
             each attention kernel's wrapper once more, for its
             host-inclusive time.
4. model   — granite-3-2b, rwkv6-1.6b and recurrentgemma-9b at full width,
             2-3 layers, float32: prefill and decode logits on the kernel
             path (default impl) against impl="dense", and decode against
             the full forward, at 2e-3 (recurrentgemma with a 64-token
             window, so the ring cache wraps).
5. graphs  — per model (granite-3-2b, rwkv6-1.6b, recurrentgemma-9b at
             full width, bf16, 8 arena rows, decode seq 2048 / 2048 /
             4096), the decode step and an 8-step chunk as CUDA graphs:
             the chunk against 8 single-step replays on the same leased,
             scattered rows (the arena snapshot and restored in place),
             bit for bit; one replay against the eager step, bit for bit
             (live logits and every arena leaf); the arena's storage
             unchanged; launches per replay against the kernel calls of
             one step.
6. serve   — full granite-3-2b (40 layers, bf16, random weights from a
             seed) served by DeepRT through build_live_scheduler, one
             prefill and one decode category; checks admission,
             conservation, no miss, zero decode captures after warm-up,
             and that both attention kernels launched while serving.
             Decode steps are CUDA-graph replays.
7. serve_multitenant — the main path: the same over full granite-3-2b,
             rwkv6-1.6b and recurrentgemma-9b from one engine and one
             DeepRT, a prefill and a decode category per model, with all
             four kernels launched while serving (the kernels line's
             launch counts are this run's, replays included).
8. serve_chunked — serve_multitenant's models and streams from an engine
             built with chunk_depth=8 (chunk WCETs profiled for k = 1,
             2, 4, 8, every chunk captured in that warm-up), plus per
             model a burst of 8 decode jobs at one instant with a 30 s
             deadline: every model serves chunks of 2 or more steps,
             with no miss and zero decode captures while serving.

Before the last line it prints the nvidia-smi line and one JSON object
with a row per kernel (`previous_ms`: the previous design's time, null
for rglru_scan; the wkv6 row also has `b1_*` and `decode_*` times and
bounds at (1, 512) and (8, 1)); the last line is the device record.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MID = "granite-3-2b"
RWKV = "rwkv6-1.6b"
RGEMMA = "recurrentgemma-9b"
# Decode seq per model in the multi-tenant serve: recurrentgemma's runs
# past its 2048-slot ring, as a user of a 2048-window model would. Its
# profiled decode step attends to a full ring (the engine presents one
# for prefix-mode steps), so its WCET covers a full window's attention.
DECODE_SEQ = {MID: 2048, RWKV: 2048, RGEMMA: 4096}
PREFILL_SEQ = 512
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


def device_ms(fn, inputs, iters: int = 20, reps: int = 5) -> float:
    """Mean device ms per call of ``fn(*inp)``, cycling through ``inputs``
    as ``time_ms`` does, with the host's cost per call taken out: the
    ``iters`` calls are captured once into a CUDA graph, which is replayed
    ``reps`` times between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


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


def in_turns(new, old, inputs):
    """(new ms, old ms): device times of the two in turns on the same
    inputs (new, old, old, new), each the mean of its two runs."""
    a = device_ms(new, inputs)
    b = device_ms(old, inputs)
    c = device_ms(old, inputs)
    d = device_ms(new, inputs)
    return (a + d) / 2, (b + c) / 2


def bound(nbytes: int, flops: int, dtype: str = "bfloat16"):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak rate for the type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")


def sass_counts(path) -> dict:
    """Tensor-core and async-copy instructions in a built library."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found = re.findall(r"\b(" + "|".join(SASS_OPS) + r")\b", text)
    return {op: found.count(op) for op in SASS_OPS}


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
    if not torch.equal(got, run_k(*base)):
        raise AssertionError("decode: two calls on the same inputs differ")
    assert_close("decode previous design", dk.previous_design(*base), run_p(*base),
                 TOL["bfloat16"])
    ms, previous_ms = in_turns(run_k, lambda *a: dk.previous_design(*a), inputs)
    eager_ms = time_ms(run_k, inputs)
    plain_ms = time_ms(run_p, inputs, iters=5, warmup=1)
    # SDPA yardstick on the same inputs, laid out (B, H, S, D) beforehand.
    lib_inputs = []
    for (q_, k_, v_, c_, p_, va_, _a) in inputs:
        mask = ((p_ <= c_[:, None]) & va_)[:, None, None, :]
        lib_inputs.append((q_.transpose(1, 2).contiguous(), k_.transpose(1, 2).contiguous(),
                           v_.transpose(1, 2).contiguous(), mask))
    lib = lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=m_, enable_gqa=True)
    library_ms = device_ms(lib, lib_inputs)
    n_live = live_slots(cur, pos, valid, act, None)
    esz = ck.element_size()
    nbytes = (q.numel() * esz * 2  # q read, out written
              + 2 * n_live * kv * d * esz  # K and V of the live slots
              + b * 4 + b * s * 4 + b * s)  # cursor, positions, validity
    flops = 4 * n_live * kv * g * d
    bound_ms, bound_by = bound(nbytes, flops)
    report.setdefault("decode_attention", {}).update(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:145",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, previous_ms=previous_ms,
        shape=f"B={b} S={s} H={h} KV={kv} D={d} bf16, all rows live, cursor S-1",
    )
    log(f"decode timed B={b} S={s} bf16 (split plan {dk.plan_splits(b, kv, s, dk._sm_count(q.device))}): "
        f"kernel {ms:.4f} ms, previous design {previous_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}; eager calls "
        f"{eager_ms:.4f} ms each "
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
    run_o = lambda q_, k_, v_: fk.previous_design(q_, k_, v_, causal=True)
    err = assert_close("flash timed case", run_k(q, k, v), run_p(q, k, v), TOL["bfloat16"])
    assert_close("flash previous design", run_o(q, k, v), run_p(q, k, v), TOL["bfloat16"])
    ms, previous_ms = in_turns(run_k, run_o, inputs)
    eager_ms = time_ms(run_k, inputs)
    plain_ms = time_ms(run_p, inputs, iters=5, warmup=1)
    lib_inputs = [tuple(t.transpose(1, 2).contiguous() for t in inp) for inp in inputs]
    lib = lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, is_causal=True, enable_gqa=True)
    library_ms = device_ms(lib, lib_inputs)
    esz = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * esz  # q, k, v read; out written
    pairs = s * (s + 1) // 2  # causal (query, key) pairs per (b, h)
    flops = 4 * b * h * d * pairs
    bound_ms, bound_by = bound(nbytes, flops)
    report.setdefault("flash_attention", {}).update(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:148",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, previous_ms=previous_ms,
        shape=f"B={b} S={s} H={h} KV={kv} D={d} bf16 causal",
    )
    log(f"flash timed B={b} S={s} bf16 causal: kernel {ms:.4f} ms, previous design "
        f"{previous_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}; eager calls {eager_ms:.4f} ms each "
        f"({nbytes} bytes, {flops} flops)")
    attention_at_recurrentgemma_shapes(torch, gen, F)
    recurrence_kernels(torch, report)
    log(f"launch counters after the kernels phase: {ops.launch_counts()}")


def attention_at_recurrentgemma_shapes(torch, gen, F):
    """Both attention kernels at recurrentgemma-9b's swa shapes: head dim
    256, one kv head for 16 query heads (MQA), window 2048; decode over a
    2048-slot ring with -1 sentinels, as the served arena presents it."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    h, kv, d, window = 16, 1, 256, 2048
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for b in (1, 8):
            q = torch.randn((b, PREFILL_SEQ, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, PREFILL_SEQ, kv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, PREFILL_SEQ, kv, d), generator=gen, device="cuda").to(dtype)
            got = fk.flash_attention(q, k, v, causal=True, window=window)
            want = fk.flash_attention_plain(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            err = assert_close(f"flash rg B={b} {dtype_name}", got, want, TOL[dtype_name])
            log(f"flash {dtype_name} B={b} S={PREFILL_SEQ} H={h} KV={kv} D={d} causal "
                f"window={window}: max_abs_err={err:.3e}")
        b, s = 8, 2048
        cursors = [4095, 3000, 2047, 2100, 5000, 2300, 2048, 9000]
        q, ck, cv, cur, pos, valid, act = decode_inputs(
            torch, b, s, h, kv, d, dtype, gen, cursors=cursors, ring=True,
            active=[1, 1, 1, 0, 1, 1, 1, 1])
        got = dk.decode_attention(q, ck, cv, cur, pos, valid, act, window=window)
        want = dk.decode_attention_plain(q, ck, cv, cur, pos, valid, act, window=window)
        torch.cuda.synchronize()
        err = assert_close(f"decode rg ring {dtype_name}", got, want, TOL[dtype_name])
        if bool(got[~act].float().abs().max() != 0):
            raise AssertionError("decode rg ring: a dead row is not exact 0")
        log(f"decode {dtype_name} B={b} S={s} H={h} KV={kv} D={d} [ring, -1 sentinels, "
            f"window {window}, a dead row]: max_abs_err={err:.3e}")
    # Times at these shapes (bf16), for the record beside granite's, each
    # in turns with the previous design, with SDPA and the bound.
    dtype = torch.bfloat16
    b = 8
    q = torch.randn((b, PREFILL_SEQ, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, PREFILL_SEQ, kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, PREFILL_SEQ, kv, d), generator=gen, device="cuda").to(dtype)
    per_copy = (q.numel() + 2 * k.numel()) * q.element_size()
    inputs = [(q, k, v)] + [(q.clone(), k.clone(), v.clone())
                            for _ in range(n_copies(per_copy) - 1)]
    ms, previous_ms = in_turns(
        lambda q_, k_, v_: fk.flash_attention(q_, k_, v_, window=window),
        lambda q_, k_, v_: fk.previous_design(q_, k_, v_, window=window), inputs)
    lib_inputs = [tuple(t.transpose(1, 2).contiguous() for t in inp) for inp in inputs]
    lib_ms = device_ms(lambda q_, k_, v_: F.scaled_dot_product_attention(
        q_, k_, v_, is_causal=True, enable_gqa=True), lib_inputs)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * b * h * d * (PREFILL_SEQ * (PREFILL_SEQ + 1) // 2)  # the window spans S
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"flash timed B={b} S={PREFILL_SEQ} H={h} KV={kv} D={d} bf16 causal window={window}: "
        f"kernel {ms:.4f} ms, previous design {previous_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, {flops} flops)")
    base = decode_inputs(torch, b, 2048, h, kv, d, dtype, gen, cursors=[4095] * b, ring=True)
    qd, ck, cv, cur, pos, valid, act = base
    per_copy = 2 * ck.numel() * ck.element_size()
    inputs = [base] + [(qd, ck.clone(), cv.clone(), cur, pos, valid, act)
                       for _ in range(n_copies(per_copy) - 1)]
    ms, previous_ms = in_turns(lambda *a: dk.decode_attention(*a, window=window),
                               lambda *a: dk.previous_design(*a, window=window), inputs)
    lib_inputs = []
    for (q_, k_, v_, c_, p_, va_, _a) in inputs:
        mask = ((p_ <= c_[:, None]) & va_ & (p_ > c_[:, None] - window))[:, None, None, :]
        lib_inputs.append((q_.transpose(1, 2).contiguous(), k_.transpose(1, 2).contiguous(),
                           v_.transpose(1, 2).contiguous(), mask))
    lib_ms = device_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=m_, enable_gqa=True), lib_inputs)
    n_live = live_slots(cur, pos, valid, act, window)
    esz = ck.element_size()
    nbytes = (qd.numel() * esz * 2 + 2 * n_live * kv * d * esz + b * 4 + b * 2048 * 5)
    flops = 4 * n_live * kv * (h // kv) * d
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"decode timed B={b} S=2048 H={h} KV={kv} D={d} bf16 ring window={window} (split plan "
        f"{dk.plan_splits(b, kv, 2048, dk._sm_count(qd.device))}): kernel {ms:.4f} ms, previous "
        f"design {previous_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({n_live} live slots, {nbytes} bytes, {flops} flops)")


def wkv6_inputs(torch, gen, b, s, h, k, dtype, w_dtype, with_state):
    """The reference tests' distributions: r/k/v scaled 0.5, w in
    (0.45, 0.95), u and the state scaled 0.1."""
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    r, kk, v = ((rn(b, s, h, k) * 0.5).to(dtype) for _ in range(3))
    w = (torch.sigmoid(rn(b, s, h, k)) * 0.5 + 0.45).to(w_dtype)
    u = (rn(h, k) * 0.1).to(dtype)
    state = rn(b, h, k, k) * 0.1 if with_state else None
    return r, kk, v, w, u, state


def rglru_inputs(torch, gen, b, s, d, dtype, with_h0):
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    a = (torch.sigmoid(rn(b, s, d)) * 0.5 + 0.45).to(dtype)
    x = (rn(b, s, d) * 0.1).to(dtype)
    return a, x, (rn(b, d) if with_h0 else None)


def recurrence_kernels(torch, report):
    """wkv6 at rwkv6-1.6b's shapes and rglru_scan at recurrentgemma-9b's,
    each against its plain version, then timed at the prefill shape."""
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels import wkv6 as wk

    gen = torch.Generator(device="cuda").manual_seed(4321)
    b, h, k = 8, 32, 64
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = ((b, PREFILL_SEQ), (b, 1), (b, 509), (1, PREFILL_SEQ))
    cases = [(bb, s, dt, wdt, st) for bb, s in shapes
             for dt, wdt in ((bf16, f32), (bf16, bf16), (f32, f32)) for st in (False, True)]
    for bb, s, dt, wdt, with_state in cases:
        r, kk, v, w, u, state = wkv6_inputs(torch, gen, bb, s, h, k, dt, wdt, with_state)
        got, last = wk.wkv6(r, kk, v, w, u, state)
        want, want_last = wk.wkv6_plain(r, kk, v, w, u, state)
        torch.cuda.synchronize()
        name = "bfloat16" if dt == bf16 else "float32"
        design = "chunked" if wk.uses_chunked(dt, s) else "sequential"
        label = (f"wkv6 B={bb} S={s} H={h} K=V={k} r/k/v {name} w {str(wdt)[6:]} "
                 f"state={with_state} [{design}]")
        err = assert_close(label, got, want, TOL[name])
        err_s = assert_close(label + " (last state)", last, want_last, TOL[name])
        log(f"{label}: max_abs_err out {err:.3e}, state {err_s:.3e}")
    # Extreme decays on the chunked design: w = 0 (log w clamped), w = 1
    # (no decay: the state grows over all 512 steps), and strong and mild
    # channels side by side.
    for label, fill in (("w = 0", 0.0), ("w = 1", 1.0), ("mixed", None)):
        r, kk, v, w, u, state = wkv6_inputs(torch, gen, b, PREFILL_SEQ, h, k, bf16, f32, True)
        if fill is None:
            w = torch.where(torch.arange(k, device="cuda") % 2 == 0, w * 1e-3, 0.99 + 0.01 * w)
        else:
            w = torch.full_like(w, fill)
        got, last = wk.wkv6(r, kk, v, w, u, state)
        want, want_last = wk.wkv6_plain(r, kk, v, w, u, state)
        torch.cuda.synchronize()
        err = max(assert_close(f"wkv6 chunked {label}", got, want, TOL["bfloat16"]),
                  assert_close(f"wkv6 chunked {label} state", last, want_last, TOL["bfloat16"]))
        again = wk.wkv6(r, kk, v, w, u, state)
        if not (torch.equal(got, again[0]) and torch.equal(last, again[1])):
            raise AssertionError(f"wkv6 chunked {label}: two calls differ")
        log(f"wkv6 chunked B={b} S={PREFILL_SEQ} {label}: max_abs_err={err:.3e}, repeat identical")
    # Decode writes the arena's state in place: state_out is the input.
    r, kk, v, w, u, state = wkv6_inputs(torch, gen, b, 1, h, k, bf16, f32, True)
    want, want_last = wk.wkv6_plain(r, kk, v, w, u, state.clone())
    got, last = wk.wkv6(r, kk, v, w, u, state, state_out=state)
    torch.cuda.synchronize()
    if last.data_ptr() != state.data_ptr():
        raise AssertionError("wkv6: state_out was not written in place")
    err = max(assert_close("wkv6 in place", got, want, TOL["bfloat16"]),
              assert_close("wkv6 in place state", state, want_last, TOL["bfloat16"]))
    log(f"wkv6 decode in place (state_out = state): max_abs_err={err:.3e}")

    bsz, d = 8, 4096
    cases = [(bb, s, dd, dt, h0) for bb, s, dd in ((bsz, PREFILL_SEQ, d), (bsz, 1, d), (3, 37, 520))
             for dt in (f32, bf16) for h0 in (False, True)]
    for bb, s, dd, dt, with_h0 in cases:
        a, x, h0 = rglru_inputs(torch, gen, bb, s, dd, dt, with_h0)
        got, last = rk.rglru_scan(a, x, h0)
        want, want_last = rk.rglru_scan_plain(a, x, h0)
        torch.cuda.synchronize()
        name = "bfloat16" if dt == bf16 else "float32"
        label = f"rglru_scan B={bb} S={s} D={dd} {name} h0={with_h0}"
        err = assert_close(label, got, want, TOL[name])
        err_h = assert_close(label + " (last h)", last, want_last, TOL[name])
        log(f"{label}: max_abs_err h {err:.3e}, last {err_h:.3e}")

    # ----- timing at the served shapes -----------------------------------
    # wkv6 (bf16 r/k/v, f32 w, an initial state read once and the last
    # state written) at rwkv6-1.6b's largest prefill bucket, its batch-1
    # prefill and its decode step, each in turns with the sequential design.
    timed = {}
    for tag, bb, s in (("", b, PREFILL_SEQ), ("b1_", 1, PREFILL_SEQ), ("decode_", b, 1)):
        base = wkv6_inputs(torch, gen, bb, s, h, k, bf16, f32, True)
        per_copy = sum(t.numel() * t.element_size() for t in base)
        inputs = [base] + [tuple(t.clone() for t in base)
                           for _ in range(n_copies(per_copy) - 1)]
        got, _ = wk.wkv6(*base)
        err = assert_close(f"wkv6 timed B={bb} S={s}", got, wk.wkv6_plain(*base)[0],
                           TOL["bfloat16"])
        ms, previous_ms = in_turns(lambda *a: wk.wkv6(*a), lambda *a: wk.previous_design(*a),
                                   inputs)
        r, kk, v, w, u, state = base
        nbytes = (3 * r.numel() * r.element_size() + w.numel() * 4
                  + u.numel() * u.element_size()
                  + r.numel() * r.element_size()  # out, in r's dtype (V = K)
                  + 2 * state.numel() * 4)  # state read and written
        flops = 4 * k * k * bb * h * s  # state update and output product, float32
        bound_ms, bound_by = bound(nbytes, flops, "float32")
        timed[tag] = dict(ms=ms, previous_ms=previous_ms, bound_ms=bound_ms, err=err)
        design = "chunked" if wk.uses_chunked(bf16, s) else "sequential"
        log(f"wkv6 timed B={bb} S={s} H={h} K=V={k} bf16/f32 [{design}]: kernel {ms:.4f} ms, "
            f"previous design (sequential) {previous_ms:.4f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by} ({nbytes} bytes, {flops} fp32 flops)")
        if tag == "":
            main_bound = (bound_ms, bound_by)
            plain_ms = time_ms(lambda *a: wk.wkv6_plain(*a), inputs, iters=3, warmup=1)
    report.setdefault("wkv6", {}).update(
        name="wkv6", route="cuda", source="src/repro_torch/kernels/csrc/wkv6.cu",
        replaces="src/repro/kernels/wkv6.py:99", max_abs_err=timed[""]["err"],
        ms=timed[""]["ms"], plain_ms=plain_ms, bound_ms=main_bound[0], bound_by=main_bound[1],
        library_ms=None, previous_ms=timed[""]["previous_ms"],
        **{f"{tag}{key}": timed[tag][key] for tag in ("b1_", "decode_")
           for key in ("ms", "previous_ms", "bound_ms")},
    )
    log(f"wkv6 plain at B={b} S={PREFILL_SEQ}: {plain_ms:.4f} ms; no single library call")
    # rglru_scan: recurrentgemma-9b's largest prefill bucket, float32 gates,
    # no h0 (the model's prefill), last h written.
    s = PREFILL_SEQ
    base = rglru_inputs(torch, gen, bsz, s, d, f32, False)[:2]
    per_copy = sum(t.numel() * t.element_size() for t in base)
    inputs = [base] + [tuple(t.clone() for t in base) for _ in range(n_copies(per_copy) - 1)]
    got, _ = rk.rglru_scan(*base)
    err = assert_close("rglru timed case", got, rk.rglru_scan_plain(*base)[0], TOL["float32"])
    ms = device_ms(lambda *a: rk.rglru_scan(*a), inputs)
    plain_ms = time_ms(lambda *a: rk.rglru_scan_plain(*a), inputs, iters=3, warmup=1)
    a = base[0]
    nbytes = 3 * a.numel() * 4 + bsz * d * 4  # a, b read; h written; last h
    flops = 2 * a.numel()
    bound_ms, bound_by = bound(nbytes, flops, "float32")
    report.setdefault("rglru_scan", {}).update(
        name="rglru_scan", route="cuda", source="src/repro_torch/kernels/csrc/rglru.cu",
        replaces="src/repro/kernels/rglru.py:94", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        previous_ms=None,
    )
    log(f"rglru_scan timed B={bsz} S={s} D={d} f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes); "
        f"no single library call")


def phase_model(torch, mid, n_layers, **overrides):
    """One model at full width, ``n_layers`` deep, float32, random weights
    from the package's own init: the kernel path (default impl) against
    impl="dense" on the same parameters, prefill plus decode against
    both, and decode against the full forward."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_for

    cfg = get_config(mid, n_layers=n_layers, param_dtype="float32", **overrides)
    m_k = model_for(cfg)
    m_d = model_for(dataclasses.replace(cfg, impl="dense"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = m_k.init(gen, device="cuda")
    b, s = 2, 129
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    with torch.no_grad():
        lk, _ = m_k.forward(params, toks)
        ld, _ = m_d.forward(params, toks)
        err = assert_close(f"{mid} forward logits", lk, ld, 2e-3)
        log(f"model {mid} {cfg.block_pattern} x{n_layers} forward B={b} S={s} f32: "
            f"logits {tuple(lk.shape)}, max_abs_err={err:.3e}")
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
        err = assert_close(f"{mid} prefill+decode logits", outs[0], outs[1], 2e-3)
        # Decode must also agree with the full forward at those positions.
        ref = ld[:, n_pre:n_pre + n_dec].transpose(0, 1)
        err2 = assert_close(f"{mid} decode vs forward", outs[0][1:], ref, 2e-3)
    log(f"model {mid} prefill {n_pre} + {n_dec} decode steps: kernel vs dense "
        f"max_abs_err={err:.3e}, decode vs forward {err2:.3e}")
    del params, caches, lk, ld
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(torch, decode_seq, streams, frames, deadline_factor, chunk_depth=1):
    """Serve full-width models (bf16, random weights from seed 0) from one
    engine and one DeepRT through build_live_scheduler: per model a
    prefill category (seq 512, batch buckets 1-8) and a decode category
    (``decode_seq[mid]``), with ``streams[kind]`` streams each. Every
    stream's deadline is ``deadline_factor`` x the sum over the models of
    one decode step plus the largest prefill (profiled WCETs), its period
    half that. Checks admission of every category, conservation, zero
    decode captures after warm-up, that every kernel the models run
    was launched while serving, and well-formed outputs. Returns the
    served run's record and launch counts.

    ``chunk_depth`` > 1 builds the engine to serve decode chunks that deep
    (every depth profiled, and captured, in the warm-up), and adds per
    model one burst of 8 decode jobs of its decode category, submitted at
    one instant with a 30 s deadline, which the EDF worker fuses into
    chunks: each model must serve at least one chunk of 2 or more steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import Category, ChunkJob, Frame, JobInstance, Request
    from repro_torch.kernels import ops
    from repro_torch.serving.batcher_bridge import build_live_scheduler
    from repro_torch.serving.engine import InferenceEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"device memory allocated before the engine: {torch.cuda.memory_allocated()} bytes")
    cfgs = {mid: get_config(mid) for mid in decode_seq}
    cats = []
    for mid, dec_seq in decode_seq.items():
        cats += [(mid, (PREFILL_SEQ,), "prefill"), (mid, (dec_seq,), "decode")]
    t0 = time.perf_counter()
    engine = InferenceEngine(cfgs, seed=0, max_slots=8, chunk_depth=chunk_depth,
                             device="cuda")
    torch.cuda.synchronize()
    for mid, cfg in cfgs.items():
        n_params = sum(t.numel() for t in _leaves(engine.params[mid]))
        log(f"engine: {mid} {cfg.n_layers} layers {cfg.block_pattern}, {n_params} parameters "
            f"({cfg.param_dtype}); decode arena seq {decode_seq[mid]}: "
            f"{engine.arena_nbytes(mid, decode_seq[mid])} bytes")
    log(f"engine made on the card in {time.perf_counter() - t0:.3f} s")

    ops.reset_launch_counts()
    t_prof = time.perf_counter()
    sched, engine, table = build_live_scheduler(
        cfgs, cats, batch_sizes=(1, 2, 4, 8), engine=engine, chunk_depth=chunk_depth)
    profiling_launches = ops.launch_counts()
    log(f"profiling (and decode captures: {len(engine._graphs)}) took "
        f"{time.perf_counter() - t_prof:.3f} s")
    wcet = {}
    for mid, dec_seq in decode_seq.items():
        w_dec = table.wcet(mid, (dec_seq,), engine.max_slots)
        w_pre = {bs: table.wcet(mid, (PREFILL_SEQ,), bs) for bs in (1, 2, 4, 8)}
        wcet[mid] = {"decode_ms": w_dec * 1e3,
                     "prefill_ms": {bs: w * 1e3 for bs, w in w_pre.items()}}
        log(f"profiled WCET {mid} (p99 of 5 runs): decode seq {dec_seq} x "
            f"{engine.max_slots} slots {w_dec * 1e3:.3f} ms; prefill seq {PREFILL_SEQ} by "
            "batch " + ", ".join(f"{bs}: {w * 1e3:.3f} ms" for bs, w in w_pre.items()))
        if chunk_depth > 1:
            depths = table.chunk_depths_profiled(mid, (dec_seq,))
            if depths != [1, 2, 4, 8]:
                raise AssertionError(f"{mid}: chunk depths profiled {depths}")
            wk = {d: table.chunk_wcet(mid, (dec_seq,), d) * 1e3 for d in depths}
            wcet[mid]["chunk_ms"] = wk
            log(f"profiled chunk WCET {mid}: " + ", ".join(
                f"k={d}: {w:.3f} ms ({w / d:.3f} ms a step)" for d, w in wk.items()))
    log(f"launches during profiling: {profiling_launches}")

    total = sum(w["decode_ms"] + w["prefill_ms"][8] for w in wcet.values()) / 1e3
    deadline = deadline_factor * total
    period = deadline / 2
    start = sched.loop.now + 0.05
    admitted = {f"{mid}/{kind}": 0 for mid, _, kind in cats}
    for mid, shape, kind in cats:
        for _ in range(streams[kind]):
            res = sched.submit_request(Request(
                Category(mid, shape), period=period, relative_deadline=deadline,
                n_frames=frames, start_time=start))
            admitted[f"{mid}/{kind}"] += int(res.admitted)
            log(f"request {mid} {kind} period={period * 1e3:.3f} ms "
                f"deadline={deadline * 1e3:.3f} ms: {'ADMIT' if res.admitted else 'REJECT'} "
                f"(phase {res.phase}, U={res.utilization:.3f})")
    if min(admitted.values()) < 1:
        raise AssertionError(f"admission: {admitted}; need >= 1 stream in every category")

    chunks = {mid: [0, 0] for mid in decode_seq}  # chunks of k >= 2, their steps
    if chunk_depth > 1:
        dispatch = sched.device.dispatch_fn

        def counting(job):
            if isinstance(job, ChunkJob) and job.k > 1:
                chunks[job.category.model_id][0] += 1
                chunks[job.category.model_id][1] += job.k
            return dispatch(job)

        sched.device.dispatch_fn = counting
        for i, (mid, dec_seq) in enumerate(decode_seq.items()):
            def burst(cat=Category(mid, (dec_seq,)), rid=10_000 + i):
                now = sched.loop.now
                for idx in range(8):
                    sched.metrics.record_ingest()
                    f = Frame(request_id=rid, category=cat, index=idx, arrival_time=now,
                              deadline=now + 30.0)
                    sched.worker.submit(JobInstance(
                        category=cat, frames=[f], release_time=now,
                        relative_deadline=30.0, shape_key=cat.shape_key))
            sched.loop.schedule(start + 0.2 * (i + 1), burst)

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
        f"throughput={m.throughput:.3f} frames/s decode_compiles={engine.stats['decode_compiles']} "
        f"chunk_submits={m.chunk_submits} chunked_steps={m.chunked_steps} "
        f"chunk_steps(engine)={engine.stats['chunk_steps']} chunks by model {chunks}")
    if m.completed_frames < 1:
        raise AssertionError("no frame completed")
    if m.completed_frames + m.dropped_frames + m.lost_frames != ingested:
        raise AssertionError("conservation: completed + dropped + lost != ingested")
    if engine.stats["decode_compiles"] != 0:
        raise AssertionError(f"decode_compiles = {engine.stats['decode_compiles']} after warm-up")
    if m.missed_frames:
        raise AssertionError(f"{m.missed_frames} frames missed their deadline")
    if chunk_depth > 1 and min(n for n, _ in chunks.values()) < 1:
        raise AssertionError(f"a model served no chunk of 2 or more steps: {chunks}")
    if chunk_depth > 1 and min(steps for _, steps in chunks.values()) < 2:
        raise AssertionError(f"chunked steps by model {chunks}")
    kinds = {k for cfg in cfgs.values() for k in cfg.block_pattern}
    needed = {"decode_attention", "flash_attention"} if kinds & {"attn", "swa"} else set()
    needed |= {"wkv6"} if "rwkv" in kinds else set()
    needed |= {"rglru_scan"} if "rglru" in kinds else set()
    for name in sorted(needed):
        if serving_launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched while serving")

    # Every model's served steps give well-formed outputs.
    for mid, cfg in cfgs.items():
        logits = engine.dispatch(mid, (decode_seq[mid],), engine.max_slots, "decode").wait()
        nxt = engine.dispatch(mid, (PREFILL_SEQ,), 8, "prefill").wait()
        if tuple(logits.shape) != (engine.max_slots, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{mid} decode logits malformed: {tuple(logits.shape)}")
        if tuple(nxt.shape) != (8,) or not bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()):
            raise AssertionError(f"{mid} prefill tokens malformed: {nxt}")
        # The served prefill returns argmax tokens only; its logits on the
        # same (zero) frame must be finite too.
        with torch.no_grad():
            pre, _ = engine.models[mid].forward(
                engine.params[mid],
                torch.zeros((1, PREFILL_SEQ), dtype=torch.long, device="cuda"))
        if not bool(torch.isfinite(pre[:, -1]).all()):
            raise AssertionError(f"{mid} prefill logits not finite")
        log(f"{mid}: decode logits {tuple(logits.shape)} finite, prefill logits finite, "
            f"prefill tokens {nxt.tolist()}")
        del pre
    # Stop the device's waiter thread: it holds the engine (and its
    # parameters, arenas and graphs) for as long as it runs.
    sched.device.close()
    return dict(
        wcet=wcet, period_ms=period * 1e3, deadline_ms=deadline * 1e3,
        miss_rate=m.miss_rate, p99_latency_ms=m.latency_percentile(0.99) * 1e3,
        throughput=m.throughput, completed=m.completed_frames, ingested=ingested,
        admitted=admitted, launches_serving=serving_launches,
        launches_profiling=profiling_launches, missed=m.missed_frames,
        chunk_submits=m.chunk_submits, chunked_steps=m.chunked_steps,
        chunks_by_model=chunks,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
    )


# Kernel wrapper calls per decode step (the captured launches of one step
# replay), by model: granite's 40 attn layers; rwkv6's 24 rwkv layers;
# recurrentgemma's 12 swa and 26 rglru layers.
CALLS_PER_STEP = {
    MID: {"decode_attention": 40, "flash_attention": 0, "wkv6": 0, "rglru_scan": 0},
    RWKV: {"decode_attention": 0, "flash_attention": 0, "wkv6": 24, "rglru_scan": 0},
    RGEMMA: {"decode_attention": 12, "flash_attention": 0, "wkv6": 0, "rglru_scan": 26},
}


def phase_graphs(torch, mid, seq, k=8):
    """One model at full width (bf16, 8 arena rows, seq ``seq``) with its
    decode step and k-step chunk as CUDA graphs. Scattered rows are
    leased at mixed cursors; the arena is snapshot, one k-step chunk runs
    with per-step row subsets (one step empty), the arena is restored IN
    PLACE, and the same k steps run as single-step replays: every arena
    leaf, the cursors, the active bitmap and each step's logits must agree
    bit for bit. Also: one step replay against the eager step on the same
    arena (restored again), bit for bit too, the arena's storage
    unchanged, and each graph's launches per replay against
    CALLS_PER_STEP."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serving.engine import InferenceEngine

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config(mid)
    engine = InferenceEngine({mid: cfg}, seed=0, max_slots=8, chunk_depth=k, device="cuda")
    arena = engine.arena(mid, seq)
    leaves = lambda: tree_leaves(arena.cache) + [arena.cur, arena.active]
    ptrs = [t.data_ptr() for t in leaves()]
    before = ops.launch_counts()
    engine.execute(mid, (seq,), 8, "decode")  # eager step, then its capture
    eager = {n: c - before[n] for n, c in ops.launch_counts().items()}
    engine.execute_chunk(mid, (seq,), 8, k)
    step_g = engine._graphs[("decode", mid, seq)]
    chunk_g = engine._graphs[("decode_chunk", mid, seq, k)]
    want = CALLS_PER_STEP[mid]
    if eager != want or step_g.launches != want:
        raise AssertionError(f"{mid}: launches per step eager {eager}, "
                             f"captured {step_g.launches}, expected {want}")
    if chunk_g.launches != {n: k * c for n, c in want.items()}:
        raise AssertionError(f"{mid}: chunk launches {chunk_g.launches}")
    captured_s = time.perf_counter() - t0

    engine.alloc_slots(mid, seq, 4, start_pos=100)
    engine.alloc_slots(mid, seq, 4, start_pos=seq - 300)
    engine.free_slots(mid, seq, [0, 5])
    live = list(arena.live)
    rows_plan = [[1, 4], [], None, [3, 6, 7], [2], None, [1, 2, 3], [4, 7]][:k]
    rng = np.random.default_rng(5)
    payloads = [{r: int(rng.integers(0, cfg.vocab_size)) for r in (live if rows is None else rows)}
                for rows in rows_plan]
    snap = [t.clone() for t in leaves()]
    ops.reset_launch_counts()
    chunk = engine.decode_chunk(mid, (seq,), len(live), k, slots=live, payloads=payloads,
                                step_rows=rows_plan).wait()
    if ops.launch_counts() != chunk_g.launches:
        raise AssertionError(f"{mid}: chunk replay counted {ops.launch_counts()}")
    after_chunk = [t.clone() for t in leaves()]
    for t, s in zip(leaves(), snap):
        t.copy_(s)
    ops.reset_launch_counts()
    steps = [engine.dispatch(mid, (seq,), len(live), "decode", slots=live,
                             payload=payloads[i], step_rows=rows_plan[i]).wait()
             for i in range(k)]
    if ops.launch_counts() != chunk_g.launches:
        raise AssertionError(f"{mid}: {k} step replays counted {ops.launch_counts()}")
    torch.cuda.synchronize()
    same_leaves = all(torch.equal(a, b) for a, b in zip(after_chunk, leaves()))
    same_logits = all(torch.equal(chunk[i], steps[i]) for i in range(k))
    if not (same_leaves and same_logits):
        bad = max(float((chunk[i] - steps[i]).abs().max()) for i in range(k))
        raise AssertionError(f"{mid}: chunk vs {k} steps not bit-identical "
                             f"(leaves {same_leaves}, logits max diff {bad:.3e})")
    if not all(bool(torch.isfinite(chunk[i][live]).all()) for i in range(k)):
        raise AssertionError(f"{mid}: non-finite chunk logits")

    # One step replay against the eager step, on the same arena.
    snap = [t.clone() for t in leaves()]
    cur, active = arena.cur.clone(), arena.active.clone()
    tok = torch.zeros(8, dtype=torch.int32, device="cuda")
    tok[live] = torch.tensor([payloads[0].get(r, 0) for r in live], dtype=torch.int32,
                             device="cuda")
    replay = engine.dispatch(mid, (seq,), len(live), "decode", slots=live,
                             payload={r: int(tok[r]) for r in live}).wait()
    after_replay = [t.clone() for t in leaves()]
    for t, s in zip(leaves(), snap):
        t.copy_(s)
    eager_logits, eager_cur = engine._decode_fn(mid, seq)(tok, cur, active)
    arena.cur.copy_(eager_cur)  # as dispatch does after the step
    torch.cuda.synchronize()
    diff = float((replay[live] - eager_logits[live]).abs().max())
    leaf_diff = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(after_replay, leaves()))
    if not (torch.equal(replay[live], eager_logits[live])
            and all(torch.equal(a, b) for a, b in zip(after_replay, leaves()))):
        raise AssertionError(f"{mid}: replay vs eager step not bit-identical (max |diff| "
                             f"logits {diff:.3e}, arena {leaf_diff:.3e})")
    if [t.data_ptr() for t in leaves()] != ptrs:
        raise AssertionError(f"{mid}: the arena's storage moved")
    log(f"graphs {mid} seq {seq}: k={k} chunk vs {k} single replays bit-identical "
        f"(rows {live}, steps {rows_plan}); replay vs eager step bit-identical "
        f"(logits and every arena leaf); launches per step replay "
        f"{step_g.launches}, per chunk {chunk_g.launches}; arena storage unchanged; "
        f"decode_compiles {engine.stats['decode_compiles']}; eager step + captures "
        f"{captured_s:.3f} s")
    del engine, snap, after_chunk, after_replay, chunk, steps
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


T_START = time.perf_counter()


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
            counts = sass_counts(path)
            log(f"  sass {name}: " + ", ".join(f"{op} {n}" for op, n in counts.items()))
            need = {"flash_attention": "HGMMA", "decode_attention": "HMMA",
                    "wkv6": "HMMA"}.get(name)
            if need and counts[need] < 1:
                raise AssertionError(f"{name}: no {need} in its SASS")
    with Phase("kernels"):
        phase_kernels(torch, report)
    with Phase("model"):
        phase_model(torch, MID, 2)
        phase_model(torch, RWKV, 2)
        phase_model(torch, RGEMMA, 3, sliding_window=64)
    with Phase("graphs"):
        for mid, seq in DECODE_SEQ.items():
            phase_graphs(torch, mid, seq)
    with Phase("serve"):
        served = phase_serve(torch, {MID: 2048}, {"decode": 4, "prefill": 2}, frames=20,
                             deadline_factor=12.0)
        log("served: " + json.dumps(served, sort_keys=True))
    with Phase("serve_multitenant"):
        served = phase_serve(torch, DECODE_SEQ, {"decode": 2, "prefill": 1}, frames=8,
                             deadline_factor=6.0)
        log("served multitenant: " + json.dumps(served, sort_keys=True))
        for name, n in served["launches_serving"].items():
            report[name]["launches"] = n
    with Phase("serve_chunked"):
        served = phase_serve(torch, DECODE_SEQ, {"decode": 2, "prefill": 1}, frames=8,
                             deadline_factor=6.0, chunk_depth=8)
        log("served chunked: " + json.dumps(served, sort_keys=True))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "previous_ms")
    names = ("decode_attention", "flash_attention", "wkv6", "rglru_scan")
    extra = ("b1_ms", "b1_previous_ms", "b1_bound_ms", "decode_ms", "decode_previous_ms",
             "decode_bound_ms")
    rows = [{k: report[n][k] for k in keys + extra if k in keys or k in report[n]}
            for n in names]
    log(f"total run time {time.perf_counter() - T_START:.3f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
