#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py            # one GPU, no arguments

Phases (each prints one line with its seconds; any failure exits non-zero):

1. device  — requires CUDA, prints the card's name and power limit,
             turns TF32 off for matmuls and cuDNN.
2. build   — builds the ten CUDA kernels from src/repro_torch/kernels/csrc
             with nvcc for sm_90a (one nvcc per source, in parallel),
             prints ptxas' register and spill lines and, from
             `cuobjdump -sass`, each library's count of tensor-core
             (HGMMA, HMMA) and async-copy (UTMALDG, LDGSTS) instructions;
             fails unless flash_attention and flash_attention_bwd have
             HGMMA, decode_attention, wkv6 and wkv6_bwd (their chunked
             designs) HMMA, and if a wgmma kernel of flash_attention_bwd
             spills or its four wide-route wgmma kernels are not all
             built, or if rglru or rglru_bwd lacks one of its chunked
             route's three kernels.
3. kernels — holds each kernel against its plain PyTorch version at the
             main path's shapes, in bf16 (2e-2) and float32 (2e-5): the
             two attention kernels at granite-3-2b's and recurrentgemma-
             9b's shapes (decode also for bit-identical repeats), wkv6 at
             rwkv6-1.6b's (both designs: chunked for bf16 from 64 steps,
             sequential for float32 and decode's single step; the chunked
             one also at extreme decays, bit-identical repeats),
             rglru_scan at recurrentgemma-9b's served and training shapes
             and ragged ones (both routes: float32 bit for bit the route's
             plain twin, the chunked one within 2e-5 of the sequential
             walk, two calls equal; extreme decays on the chunked route);
             times kernel, plain
             version and, for attention, SDPA (the yardstick), and the
             previous design in turns with the kernel (new, old, old,
             new): bf16 attention, wkv6 at (B, S) = (8, 512), (1, 512)
             and (8, 1) against its sequential design, and rglru_scan at
             (B, S, D) = (8, 512, 4096) and (1, 4096, 4096) against its
             streaming design (fails unless the training shape is 2x
             faster and the served one within 3%); the row-norm kernel
             (RMS and layer norm) against its plain chain at d 2048 and
             16384, timed in bf16 at 4096, 7936 and 32 rows x 2048 in
             turns with the eager chain it replaced, beside PyTorch's
             one-call F.rms_norm / F.layer_norm (fails under 60% of its
             bytes bound at 4096 x 2048 RMS). Kernel, previous
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
             4096), the decode step as a CUDA graph and an 8-step chunk
             as 8 replays of it: one capture for the model's (mid, seq)
             and none per depth; the chunk against 8 single-step replays
             on the same leased, scattered rows (the arena snapshot and
             restored in place), bit for bit; one replay against the
             eager step, bit for bit (live logits and every arena leaf);
             the arena's storage unchanged; launches per replay against
             the kernel calls of one step.
6. serve   — full granite-3-2b (40 layers, bf16, random weights from a
             seed) served by DeepRT through build_live_scheduler, one
             prefill and one decode category; checks admission,
             conservation, no miss, zero decode and zero prefill captures
             after warm-up, and that both attention kernels launched while
             serving. Decode steps and prefill buckets are CUDA-graph
             replays: per model one prefill replay at batch 1 and at batch
             8 against the eager body on the same tokens, bit for bit (the
             next tokens, and the last position's logits through a
             last_logits graph captured the same way). Phases 7, 8, 13 and
             14 serve through the same code and make the same checks.
7. serve_multitenant — the main path: the same over full granite-3-2b,
             rwkv6-1.6b and recurrentgemma-9b from one engine and one
             DeepRT, a prefill and a decode category per model, with all
             four kernels launched while serving (the kernels line's
             launch counts are this run's, replays included).
7b. hybrid — granite-4.0-h-micro (36 Mamba-2 + 4 NoPE attention layers):
             `ssd_chunk` against its twin (bf16 8 x 512, 1 x 992, 2 x 100,
             float32 2 x 130 also against the step-by-step recurrence) and
             timed alone at 8 x 512 and 4 x 512 beside the twin and its
             bound; `ssd_step` at 32 rows, half held (held rows untouched),
             timed at 32 stepped rows, failing under 60% of its bytes
             bound; the gated row norm; one period (10 layers) in float32
             kernel vs dense; its 40-layer step graph (`graphs`); served
             alone at full width and depth (`serve`).
8. serve_chunked — serve_multitenant's models and streams from an engine
             built with chunk_depth=8 (chunk WCETs profiled for k = 1,
             2, 4, 8: k replays of the step graph, captured once in that
             warm-up), plus per model a burst of 8 decode jobs at one
             instant with a 30 s deadline: every model serves chunks of
             2 or more steps, with no miss and zero decode captures
             while serving.
9. cluster — full granite-3-2b on three slices of the card
             (build_live_cluster: an engine, a 4-row 2048-seq arena, a
             profiled table and an AsyncDevice each; Phase-1 bounds 1/3),
             decode streams with real tokens on leased rows and prefill
             streams through the ingest gateway; the busiest slice is
             killed mid-decode with fail_slice. Checks that every
             displaced request sits in exactly one ledger, conservation,
             zero decode captures on survivors, a frozen dead engine;
             logs misses, p99 and each slice's WCETs.
10. faults — three slices with the watchdog armed: slice0 wedges on its
             third served submit, slice1 is throttled on three spaced
             submits, behind FaultyDevice. The slices share one CUDA
             stream; each job's watchdog clock starts when the stream
             reaches it (a CUDA event ahead of its launches). Checks that slice0 is
             quarantined as hung with no operator call, slice1 degrades
             but lives, conservation, zero survivor captures; logs the
             time from the stall to the quarantine.
11. gateway — the ingest gateway over two slices built with
             chunk_depth=8: camera and bursty decode streams (seeded
             tokens), a prefill stream, a stream closed early, and a
             reconnecting client's 8-frame backlog on a leased row that
             the EDF worker fuses into chunks. Checks leases released,
             shed frames counted three ways, a chunk of 2 or more steps,
             and each decode stream's leased-row logits bit-equal to a
             twin engine of the same max_slots replaying that stream
             alone.
12. transport — the datagram transport in front of two granite slices
             (build_live_transport, bounds 1/2): 4 decode streams and 1
             prefill stream, each over a SimLink with the reference's
             chaos mix (drop, duplicate, reorder, delay) from its own
             seed; session 1's home slice failed mid-stream. Checks every
             delivered payload against its source's bytes, in order and
             once; wire and frame conservation; every displaced request
             in one ledger; real bytes delivered after the re-home; zero
             survivor captures; a frozen dead engine. Then one decode
             stream over UdpClientLink -> UdpServerBinding on 127.0.0.1
             (HELLO/HELLO_ACK, its bytes checked).
13. serve_moe — mixtral-8x7b at full width, MOE_LAYERS (16) of its 32
             layers, bf16: 2-layer float32 numerics (kernel path against
             the dense path and the dense MoE oracle, decode against
             forward, at a drop-free capacity), both attention kernels
             at its head shapes, its step graph (replay = eager, an
             8-step chunk = 8 replays, bit for bit), then served by
             DeepRT (a prefill and a decode category): no miss, zero
             decode captures while serving, both attention kernels
             launched; logs weights, peak memory, WCETs and the
             token-expert pairs dropped past capacity.
14. serve_zoo — the engine-served archs not served above, one at a time
             at full width, bf16, seed 0 (each engine, its graphs and the
             allocator's cache freed before the next): gemma3-12b (all 48
             layers), phi4-mini-3.8b (all 32), llama3-405b (4 of 126) and
             llama4-maverick-400b-a17b (1 of 48): both attention kernels
             at the arch's shapes against their plain versions in bf16
             and float32 (flash causal at B = 1 and 8 x 512, gemma3's
             local window 1024 too; decode over the 8-row arena at seq
             2048, gemma3's local layers over their 1024-slot ring), the
             bf16 batch-8 shapes timed beside SDPA; then served by DeepRT
             (1 prefill + 2 decode streams, 8 frames, deadline 6 x (decode
             + batch-8 prefill WCET)): conservation, no miss, zero decode
             captures after warm-up, the step graph's launches against
             CALLS_PER_STEP, one replay against the eager step bit for bit
             on rows leased at spread cursors; logs WCETs, weights, arena
             and peak memory, and llama4's dropped token-expert pairs.
15. multitenant_driver — the port's end-to-end driver
             (`repro_torch.launch.serve_multitenant.serve`) over
             full-width granite-3-2b and rwkv6-1.6b in the reference
             driver's four topologies: one device with its DeepRT and
             BATCH-4 lines, 2 slices, 2 slices behind the ingest gateway
             with camera sources, 2 slices behind the datagram transport
             with a Chrome trace written to a temporary file. Each run:
             conservation, zero decode and zero prefill captures on every
             slice, flash and wkv6 launched, and on each live slice's
             engine one prefill replay per model at batch 1 and 8 against
             the eager body, bit for bit; logs each slice's host stall a
             job and the run's peak memory; the trace run wrote spans.
16. examples — `python -m repro_torch.launch.quickstart` and
             `... cluster_sim` as functions: the virtual clock, no device;
             logs their lines and seconds; fails unless quickstart's
             admitted frames all met their deadlines and cluster_sim
             placed 39 of its 40 requests.
17. encdec — whisper-large-v3 through the model API (the reference's
             engine does not serve it): both attention kernels at its
             shapes against their plain versions (flash non-causal over
             1500 frames, causal, and cross at S_kv = 1500; decode over
             the 448-slot self cache and, causal=False, the 1500-frame
             cross cache), timed with SDPA; 2 + 2 layers in float32
             (kernel path against impl="dense", decode against forward,
             2e-3); then 32 + 32 layers in bf16, 8 rows (one dead), 1500
             seeded frame embeddings: encode_for_decode, 32 greedy decode
             steps, a teacher-forced forward over the same tokens (decode
             within BF16_LOGIT_TOL_STD of the logits' std, argmax up to
             near-ties on live rows); the parameters saved through the
             port's CheckpointManager (async) and restored onto the card,
             torch.equal per leaf; logs the save stall, write and restore
             times and both kernels' launches, by shape.
18. mrope — qwen2-vl-72b through the model API, MROPE_LAYERS (24) of its
             80 layers at full width: flash on Qwen2-VL position ids (an
             image's 256 tokens share one temporal position) and decode at
             its heads against their plain versions, timed with SDPA (an
             explicit mask for the position-valued case); 2 layers in
             float32 (kernel against dense, 2e-3); then bf16: a batch-8 x
             512 forward on vision positions, kernel against dense; prefill
             on them and 32 decode steps at the default mrope_position,
             kernel against dense; on text-only positions, decode against
             the teacher-forced forward.
19. train — training. (a) The flash backward
             kernel against its plain version on the kernel's own O and
             LSE (and the forward's LSE against its plain one), two calls
             torch.equal: granite-3-2b's training shape (B = 8, S = 1024,
             H = 32, KV = 8, D = 64, causal) in bf16 (2e-2) and float32
             (2e-5), whisper-large-v3's encoder (S = 1500, non-causal) and
             decoder cross (S = 448, S_kv = 1500), qwen2-vl-72b's on the
             mrope phase's position ids, recurrentgemma-9b's local
             attention (B = 1, S = 4096, H = 16, KV = 1, D = 256, window
             2048: the bf16 D > 128 wide wgmma route, its dK/dV split
             over the group's query heads) and gemma3-12b's layout (KV =
             8, window 1024: the wide route unsplit), each timed
             (CUDA-graph replays) in turns with its previous design (the
             mma.sync kernels), beside its plain version, the backward of
             one SDPA call (eager) and its bound, each design's launches
             also timed apart (torch.profiler). The two recurrences'
             backward kernels, wkv6_bwd at rwkv6-1.6b's training shape
             (B = 8, S = 1024, H = 32, K = V = 64) and rglru_bwd at
             recurrentgemma-9b's (B = 1, S = 4096, D = 4096), each against
             autograd through its plain forward in bf16 (2e-2) and float32
             (2e-5), with an initial state and at S = 1000, two calls
             torch.equal, timed (CUDA-graph replays) beside the plain
             backward and the bound; wkv6_bwd (bf16: the chunked design)
             in turns with its sequential design, rglru_bwd (chunked at
             the training shape, also held bit for bit against its
             route's plain twin, at ragged D, the served batch's
             streaming shape and extreme decays) in turns with its
             streaming design (fails unless 3x faster), each design's
             launches timed apart. (b) Three full-width runs of 10 steps
             of make_train_step (bf16, remat on, seeded Zipf tokens, AdamW):
             granite-3-2b (40 layers, 8 x 1024), rwkv6-1.6b (24 layers,
             8 x 1024) and recurrentgemma-9b (12 of 38 layers: four rglru,
             rglru, swa periods, 1 x 4096): finite losses, the last
             three's mean below the first three's, and per step exactly
             two forwards and one backward per layer's kernel (granite 80
             flash forwards and 40 backward launches; rwkv6 48 wkv6 and 24
             wkv6_bwd; recurrentgemma 16 rglru_scan, 8 rglru_bwd, 8 flash
             forwards and 4 flash backwards) and two row-norm launches per
             block norm plus the final norm's (161, 97 and 49), none of
             the others; logs
             step ms, tokens/s, peak memory and every loss (granite's
             beside the first backward design's). (c) At full width,
             every gradient leaf through the kernels against
             impl="dense" (2e-2 of the leaf's max abs): granite-3-2b
             (bf16) and rwkv6-1.6b (float32) at 2 layers,
             recurrentgemma-9b (bf16) at 3; logged beside them, how far
             rounding rwkv6's wkv output to bf16 alone moves its bf16
             dense gradients (why rwkv6 is held in float32); on granite,
             the resume drill through CheckpointManager on a TrainState
             (6 steps straight == 3 + save + restore + 3, torch.equal,
             deterministic algorithms on); the launcher
             (`python -m repro_torch.launch.train --tiny`) crashing at step
             7 and resuming from step 5, its final state digest equal to
             a straight run's; the launcher trains on the (1, 1) host mesh.
20. sharding — the host mesh (`launch/mesh.make_host_mesh`: (1, 1)
             ("data", "model") over cuda:0 on NCCL); granite-3-2b at full
             width (40 layers, TRAIN_BATCH x TRAIN_SEQ, remat on) takes 3
             AdamW steps unmeshed and 3 on the mesh (state laid out by
             shardings_for_state, the batch by batch_sharding, the
             activation resolver installed) from the same seed-0 state,
             deterministic algorithms on: every loss and every state leaf
             equal bit for bit, flash forward and backward and row-norm
             launches a step the same (80, 40 and 161) in both; logs both
             arms' step ms.
             mixtral-8x7b at full width, 2 layers: one forward with
             set_moe_mesh(host mesh) through MoE's local path (its calls
             counted) against the global path, logits and aux bit for
             bit. Then the dry run in subprocesses on the CPU
             (`python -m repro_torch.launch.dryrun`, fake groups of 256 and
             512 ranks, fake tensors): granite-3-2b train_4k on both meshes
             and llama4-maverick-400b-a17b decode_32k with --opt moe_local,
             every cell OK; logs each cell's per-rank bytes, roofline terms
             (reckoned from the H100's rates, not measured) and seconds.

Each serving phase sets the kernel launch counts to 0 before it serves
and reads them after, and fails unless every kernel of its path
launched.

Before the last line it prints the nvidia-smi line and one JSON object
with a row per kernel, eight rows (`previous_ms`: the previous design's
time, for rownorm the eager chain's, replayed, and its `library_ms`
F.rms_norm's; the rglru_scan row also has `train_*` times and the bound at the
training shape (1, 4096, 4096);
the wkv6 row also has `b1_*` and `decode_*` times and bounds at (1, 512)
and (8, 1); the attention rows carry `shapes`, a record per timed
whisper / qwen2-vl / recurrentgemma / gemma3 shape and per timed
serve_zoo shape; the backward rows a
`split` of each design's launches); the last line is the device
record. A backward kernel's launches are those of the first full-width
train run that launches it: granite's for flash_attention_bwd, rwkv6's
for wkv6_bwd, recurrentgemma's for rglru_bwd.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MID = "granite-3-2b"
RWKV = "rwkv6-1.6b"
RGEMMA = "recurrentgemma-9b"
GRANITE4H = "granite-4.0-h-micro"
MIXTRAL = "mixtral-8x7b"
# mixtral-8x7b at full width is 46.7B parameters, 93 GB in bf16: past the
# card's 80 GB. It is served 16 of its 32 layers deep (23.5B parameters,
# about 47 GB), every width as published.
MOE_LAYERS = 16
GEMMA3 = "gemma3-12b"
PHI4 = "phi4-mini-3.8b"
LLAMA3 = "llama3-405b"
LLAMA4 = "llama4-maverick-400b-a17b"
# serve_zoo's depths at full width: every layer where the bf16 weights fit
# the card beside the served run (gemma3 23.5 GB, phi4-mini 7.7 GB), else
# the depth that does (llama3-405b 33.9 GB, llama4-maverick 36.7 GB, by
# param_count_estimate).
ZOO_LAYERS = {GEMMA3: 48, PHI4: 32, LLAMA3: 4, LLAMA4: 1}
ZOO_DECODE_SEQ = 2048
WHISPER = "whisper-large-v3"
QWEN_VL = "qwen2-vl-72b"
# qwen2-vl-72b at full width is 72.7B parameters, 145 GB in bf16: past the
# card's 80 GB. It runs 24 of its 80 layers (about 23.6B parameters,
# 47 GB), every width as published.
MROPE_LAYERS = 24
WHISPER_FRAMES = 1500  # the encoder's frames for Whisper's 30 s window
WHISPER_DEC_SLOTS = 448  # Whisper's decoder context
WHISPER_STEPS = 32
MROPE_STEPS = 32
QWEN_DECODE_SEQ = 2048
IMAGE_GRID = (16, 16)  # the image's tokens in the LLM's grid (Qwen2-VL)
# bf16 logits of two paths through a full-depth model (decode against the
# teacher-forced forward, the kernel path against the dense path) differ
# by the rounding of every layer's output; they must agree elementwise
# within this fraction of the forward logits' standard deviation (a wrong
# mask or rotation moves logits by about one). In float32, at 2 layers,
# the same paths agree at 2e-3.
BF16_LOGIT_TOL_STD = 0.25
# Decode seq per model in the multi-tenant serve: recurrentgemma's runs
# past its 2048-slot ring, as a user of a 2048-window model would. Its
# profiled decode step attends to a full ring (the engine presents one
# for prefix-mode steps), so its WCET covers a full window's attention.
DECODE_SEQ = {MID: 2048, RWKV: 2048, RGEMMA: 4096}
PREFILL_SEQ = 512
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 FMA
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# wkv6_bwd's du: the share of the sum of its terms' magnitudes that two float32
# summation orders may differ by (about 14 times the 7e-8 an H100 read in
# float32 at B = 8, S = 1000, H = 32, K = V = 64).
DU_EPS = 1e-6
L2_BYTES = 50 * 2**20
# The row-norm kernel's timed rows at d 2048: granite's 8 x 512 and 8 x 992
# prefill buckets, then granite.chat's 32 decode rows; eps by kind (center).
ROWNORM_ROWS = (4096, 7936, 32)
ROWNORM_EPS = {False: 1e-6, True: 1e-5}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 10
# recurrentgemma-9b trains on one 4096-token row, so its 2048 window masks
# half of each late query's keys; 12 of its 38 layers (four rglru, rglru,
# swa periods) fit one card with AdamW's state (the 38 need about 113 GB).
RGEMMA_TRAIN_BATCH, RGEMMA_TRAIN_SEQ, RGEMMA_TRAIN_LAYERS, RGEMMA_WINDOW = 1, 4096, 12, 2048
# gemma3-12b's local attention layout (H 16, KV 8, D 256, window 1024) at
# recurrentgemma's training length: the wide route without the head split.
GEMMA3_SEQ, GEMMA3_WINDOW = 4096, 1024
TRAIN_LR = 5e-4
# The full-width train phase's ten losses with the backward's first design
# (the mma.sync kernels; the same seeds and steps, on an H100 80GB HBM3),
# logged beside this run's.
FIRST_DESIGN_LOSSES = (11.188, 11.455, 15.117, 9.995, 16.705, 10.553, 9.336, 8.647, 8.448, 8.291)


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


def launch_split(torch, fn, inputs, calls: int = 10) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches, by the
    kernel's short name, from torch.profiler over ``calls`` eager calls
    cycling through ``inputs`` (after two warm-up calls)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0:
            m = re.search(r"(\w+_kernel)", ev.key)
            name = m.group(1) if m else ev.key[:40]
            out[name] = out.get(name, 0.0) + ev.device_time_total / 1e3 / calls
    if not out:
        raise AssertionError("torch.profiler recorded no device time")
    return out


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")


def wgmma_spills(ptxas_log: str) -> dict:
    """Spill bytes (stores + loads) of every kernel whose name has
    "wgmma", from nvcc's -Xptxas -v output."""
    import re

    out, name = {}, None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1) if "wgmma" in m.group(1) else None
            short = re.search(r"\d+([a-z_]*wgmma_kernel)ILi(\d+)ELb(\d)", name or "")
            if short:  # e.g. dkdv_wgmma_kernel<64, kPos=1>
                name = f"{short.group(1)}<{short.group(2)}, kPos={short.group(3)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name is not None:
            out[name] = int(m.group(1)) + int(m.group(2))
            name = None
    return out


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
    # recurrentgemma-9b's swa shapes: head dim 256, one kv head for 16
    # query heads (MQA), window 2048, decode over a 2048-slot ring.
    attention_at_shapes(torch, report, RGEMMA, 16, 1, 256, [2048], previous=True)
    recurrence_kernels(torch, report)
    rownorm_kernels(torch, report)
    log(f"launch counters after the kernels phase: {ops.launch_counts()}")


def rownorm_inputs(torch, gen, rows, d, dtype, w_dtype, center):
    x = (3 * torch.randn((rows, d), generator=gen, device="cuda") + 0.5).to(dtype)
    w = (0.1 * torch.randn(d, generator=gen, device="cuda") + float(center)).to(w_dtype)
    b = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype) if center else None
    return x, w, b


def rownorm_kernels(torch, report):
    """The row-norm kernel against its plain chain (both kinds, both
    dtypes, weights in either dtype) at granite's d 2048 and the zoo's
    widest, two calls equal; then timed alone in bf16 at ROWNORM_ROWS x
    2048, both kinds, as CUDA-graph replays over inputs past L2, in turns
    with the eager chain it replaced (replayed the same way, and eager),
    beside PyTorch's one-call norm of the same function (``F.rms_norm``
    with ``1 + w`` made beforehand, ``F.layer_norm``: timed here only, the
    port never calls them) and its bytes bound: x read and y written once,
    plus the weights."""
    import torch.nn.functional as F

    from repro_torch.kernels import rownorm as rn

    gen = torch.Generator(device="cuda").manual_seed(4321)
    d = 2048
    errs = {}
    for center in (False, True):
        eps = ROWNORM_EPS[center]
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            for w_dtype in (torch.bfloat16, torch.float32):
                for rows, width in ((4096, d), (3, 16384)):
                    x, w, b = rownorm_inputs(torch, gen, rows, width, dtype, w_dtype, center)
                    got = rn.rownorm(x, w, b, eps=eps, center=center)
                    want = rn.rownorm_plain(x, w, b, eps=eps, center=center)
                    torch.cuda.synchronize()
                    label = (f"rownorm {'layer' if center else 'rms'} {rows} x {width} "
                             f"{dtype_name}, {w_dtype} weights")
                    err = assert_close(label, got, want, TOL[dtype_name])
                    if not torch.equal(got, rn.rownorm(x, w, b, eps=eps, center=center)):
                        raise AssertionError(f"{label}: two calls on the same inputs differ")
                    errs[dtype_name] = max(errs.get(dtype_name, 0.0), err)
                    log(f"{label}: max_abs_err={err:.3e}")
    shapes = {}
    for center in (False, True):
        eps, kind = ROWNORM_EPS[center], "layer" if center else "rms"
        for rows in ROWNORM_ROWS:
            base = rownorm_inputs(torch, gen, rows, d, torch.bfloat16, torch.bfloat16, center)
            x, w, b = base
            inputs = [base] + [(x.clone(), w, b)
                               for _ in range(n_copies(x.numel() * x.element_size()) - 1)]
            run_k = lambda x_, w_, b_: rn.rownorm(x_, w_, b_, eps=eps, center=center)
            run_p = lambda x_, w_, b_: rn.rownorm_plain(x_, w_, b_, eps=eps, center=center)
            ms, chain_ms = in_turns(run_k, run_p, inputs)
            eager_chain_ms = time_ms(run_p, inputs)
            if center:
                library_ms = device_ms(lambda x_, w_, b_: F.layer_norm(x_, (d,), w_, b_, eps),
                                       inputs)
            else:
                w1 = (1.0 + w.float()).to(w.dtype)
                library_ms = device_ms(lambda x_, w_, b_: F.rms_norm(x_, (d,), w1, eps), inputs)
            nbytes = 2 * x.numel() * x.element_size() + (2 if center else 1) * d * 2
            bound_ms, bound_by = bound(nbytes, 0)
            shapes[f"{kind} {rows}x{d} bf16"] = dict(
                ms=ms, previous_ms=chain_ms, plain_ms=eager_chain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_share=bound_ms / ms)
            log(f"rownorm timed {kind} {rows} x {d} bf16: kernel {ms:.4f} ms, the eager chain "
                f"{chain_ms:.4f} ms replayed / {eager_chain_ms:.4f} ms eager, library "
                f"{library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({100 * bound_ms / ms:.1f}% of it; "
                f"{nbytes} bytes), plan {rn.plan(d, 2)}")
    main = shapes[f"rms {ROWNORM_ROWS[0]}x{d} bf16"]
    if main["bound_share"] < 0.6:
        raise AssertionError(f"rownorm: {100 * main['bound_share']:.1f}% of its bytes bound at "
                             f"{ROWNORM_ROWS[0]} x {d} bf16, under 60%")
    report["rownorm"] = dict(
        name="rownorm", route="cuda", source="src/repro_torch/kernels/csrc/rownorm.cu",
        replaces="none (XLA fuses src/repro/models/layers.py rmsnorm / layernorm)",
        max_abs_err=errs["bfloat16"], f32_max_abs_err=errs["float32"],
        bf16_max_abs_err=errs["bfloat16"], ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by="bytes", library_ms=main["library_ms"],
        previous_ms=main["previous_ms"], shape=f"rms {ROWNORM_ROWS[0]} x {d} bf16",
        shapes=shapes)


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
    each against its plain version, then timed (``rglru_kernel_checks``
    for rglru_scan)."""
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
    rglru_kernel_checks(torch, report)


def float64_departure(got, want64) -> float:
    """max |got - want64| / (1 + |want64|): the share of the float32
    tolerance's form (tol + tol |want|) that ``got`` uses against a float64
    answer."""
    return float(((got.double() - want64).abs() / (1 + want64.abs())).max().item())


def rglru_check(torch, label, a, x, h0, exact=False):
    """One rglru_scan call against its plain version (the sequential walk,
    at the dtype's tolerance) and, on the chunked route, against the
    chunked twin (``torch.equal`` in float32); two calls equal. With
    ``exact`` (decays a hair below 1, where the float32 sequential walk
    itself departs from the exact answer by more than 2e-5 over thousands
    of steps), the oracle is the walk in float64 instead: the kernel no
    further from it than the float32 sequential walk, within 2e-5.
    Returns (max abs err of h, of the last h, route name)."""
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels.ref import rglru_chunked_plain, rglru_ref

    got, last = rk.rglru_scan(a, x, h0)
    again = rk.rglru_scan(a, x, h0)
    want, want_last = rk.rglru_scan_plain(a, x, h0)
    torch.cuda.synchronize()
    if not (torch.equal(got, again[0]) and torch.equal(last, again[1])):
        raise AssertionError(f"{label}: two calls differ")
    name = "bfloat16" if a.dtype == torch.bfloat16 else "float32"
    plan = rk.route(a)
    if plan is not None:
        label += f" [chunked L={plan[0]} n={plan[1]}]"
        twin, twin_last = rglru_chunked_plain(a, x, h0, plan[0])
        if name == "float32" and not (torch.equal(got, twin) and torch.equal(last, twin_last)):
            raise AssertionError(f"{label}: not bit for bit the chunked twin")
        assert_close(label + " (chunked twin)", got, twin, TOL[name])
    else:
        label += " [streaming]"
        if name == "float32" and not (torch.equal(got, want) and torch.equal(last, want_last)):
            raise AssertionError(f"{label}: not bit for bit the sequential plain version")
    if exact:
        w64 = rglru_ref(a.double(), x.double(), None if h0 is None else h0.double())[0]
        dep, dep_seq = float64_departure(got, w64), float64_departure(want, w64)
        if not dep <= dep_seq + TOL[name]:
            raise AssertionError(f"{label}: {dep:.3e} from the float64 walk, the float32 "
                                 f"sequential walk {dep_seq:.3e}")
        log(f"{label}: from the float64 walk {dep:.3e} (the float32 sequential walk "
            f"{dep_seq:.3e}), two calls equal")
        return dep, dep, "chunked" if plan is not None else "streaming"
    err = assert_close(label, got, want, TOL[name])
    err_h = assert_close(label + " (last h)", last, want_last, TOL[name])
    log(f"{label}: max_abs_err h {err:.3e}, last {err_h:.3e}, two calls equal")
    return err, err_h, "chunked" if plan is not None else "streaming"


def rglru_timed(torch, gen, bsz, s, d, new, old):
    """(new ms, old ms, bound ms, bound by, max abs err of ``new`` against
    the sequential plain version, the route's name) for rglru_scan at
    (bsz, s, d) float32
    with no h0 (the model's prefill and train step), ``new`` and ``old``
    timed in turns as CUDA-graph replays over copies past L2."""
    from repro_torch.kernels import rglru as rk

    base = rglru_inputs(torch, gen, bsz, s, d, torch.float32, False)[:2]
    inputs = copies(base, 2 * base[0].numel() * 4)
    err = assert_close(f"rglru timed B={bsz} S={s}", new(*base)[0], rk.rglru_scan_plain(*base)[0],
                       TOL["float32"])
    ms, old_ms = in_turns(new, old, inputs)
    nbytes = 3 * base[0].numel() * 4 + bsz * d * 4  # a, b read; h written; last h
    bound_ms, bound_by = bound(nbytes, 2 * base[0].numel(), "float32")
    route = "streaming" if rk.route(base[0]) is None else "chunked"
    del base, inputs
    return ms, old_ms, bound_ms, bound_by, err, route


def rglru_kernel_checks(torch, report):
    """rglru_scan at recurrentgemma-9b's served and training shapes and
    ragged ones, on both routes, at extreme decays; then timed in turns
    with ``previous_design`` (the streaming kernel) at the served prefill
    (B = 8, S = 512) and the train step's shape (B = 1, S = 4096)."""
    from repro_torch.kernels import rglru as rk

    gen = torch.Generator(device="cuda").manual_seed(4322)
    f32, bf16 = torch.float32, torch.bfloat16
    bsz, d = 8, 4096
    shapes = ((bsz, PREFILL_SEQ, d), (bsz, 1, d), (3, 37, 520), (1, RGEMMA_TRAIN_SEQ, d),
              (2, 1000, 520), (1, PREFILL_SEQ, d))
    routes = set()
    for bb, s, dd in shapes:
        for dt in (f32, bf16):
            for with_h0 in (False, True):
                a, x, h0 = rglru_inputs(torch, gen, bb, s, dd, dt, with_h0)
                name = "bfloat16" if dt == bf16 else "float32"
                routes.add(rglru_check(torch, f"rglru_scan B={bb} S={s} D={dd} {name} "
                                       f"h0={with_h0}", a, x, h0)[2])
    if routes != {"chunked", "streaming"}:
        raise AssertionError(f"rglru_scan: the cases took only {routes}")
    # Extreme decays on the chunked route: products that underflow through
    # the denormals to 0, decays near 1, decays a hair below 1 (no
    # forgetting over 4096 steps: held against the float64 walk), and
    # strong and faint decays side by side.
    near0, hair = (lambda u: u * 1e-3), (lambda u: 1 - 1e-6 * u)
    for label, fill, exact in (
            ("a = 1e-3 u", near0, False), ("a = 1e-20", lambda u: u * 0 + 1e-20, False),
            ("a = 0.99 + 0.01 u", lambda u: 0.99 + 0.01 * u, False),
            ("a = 1 - 1e-6 u", hair, True),
            ("mixed", lambda u: torch.where(torch.arange(u.shape[-1], device="cuda") % 2 == 0,
                                            near0(u), hair(u)), True)):
        a, x, h0 = rglru_inputs(torch, gen, 1, RGEMMA_TRAIN_SEQ, 520, f32, True)
        a = fill(torch.rand(a.shape, generator=gen, device="cuda")).contiguous()
        rglru_check(torch, f"rglru_scan extreme decays {label} B=1 S={RGEMMA_TRAIN_SEQ} D=520",
                    a, x, h0, exact=exact)

    prev = lambda *x: rk.previous_design(*x)  # noqa: E731
    run = lambda *x: rk.rglru_scan(*x)  # noqa: E731
    ms, previous_ms, bound_ms, bound_by, err, route = rglru_timed(torch, gen, bsz, PREFILL_SEQ,
                                                                  d, run, prev)
    t_ms, t_prev, t_bound, _, t_err, t_route = rglru_timed(torch, gen, 1, RGEMMA_TRAIN_SEQ, d,
                                                           run, prev)
    base = rglru_inputs(torch, gen, bsz, PREFILL_SEQ, d, f32, False)[:2]
    plain_ms = time_ms(lambda *a: rk.rglru_scan_plain(*a), [base], iters=3, warmup=1)
    del base
    for tag, b_, s_, m, p_, bd, design in (
            ("served", bsz, PREFILL_SEQ, ms, previous_ms, bound_ms, route),
            ("train", 1, RGEMMA_TRAIN_SEQ, t_ms, t_prev, t_bound, t_route)):
        log(f"rglru_scan timed {tag} B={b_} S={s_} D={d} f32 [{design}]: kernel {m:.4f} ms, "
            f"previous design (streaming) {p_:.4f} ms (in turns, {p_ / m:.2f}x), bound {bd:.4f} "
            f"ms by {bound_by}")
    if not t_ms * 2 <= t_prev:
        raise AssertionError(f"rglru_scan at the training shape: {t_ms:.4f} ms is not 2x faster "
                             f"than its previous design's {t_prev:.4f} ms")
    if not ms <= previous_ms * 1.03:
        raise AssertionError(f"rglru_scan at the served shape: {ms:.4f} ms, slower than its "
                             f"previous design's {previous_ms:.4f} ms beyond 3%")
    report.setdefault("rglru_scan", {}).update(
        name="rglru_scan", route="cuda", source="src/repro_torch/kernels/csrc/rglru.cu",
        replaces="src/repro/kernels/rglru.py:94", max_abs_err=max(err, t_err), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        previous_ms=previous_ms, train_ms=t_ms, train_previous_ms=t_prev, train_bound_ms=t_bound,
    )
    log(f"rglru_scan plain at B={bsz} S={PREFILL_SEQ} D={d}: {plain_ms:.4f} ms; no single "
        f"library call")


def phase_model(torch, mid, n_layers, **overrides):
    """One model at full width, ``n_layers`` deep, float32, random weights
    from the package's own init: the kernel path (default impl) against
    impl="dense" on the same parameters, prefill plus decode against
    both, and decode against the full forward. For a MoE model the dense
    side's full-sequence passes also run the dense MoE oracle (every token
    through every expert), so ``moe_capacity_factor`` must leave the
    dispatch drop-free (>= n_experts / top_k)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_for

    cfg = get_config(mid, n_layers=n_layers, param_dtype="float32", **overrides)
    m_k = model_for(cfg)
    m_d = model_for(dataclasses.replace(cfg, impl="dense", moe_dense=cfg.is_moe))
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


def phase_serve(torch, decode_seq, streams, frames, deadline_factor, chunk_depth=1,
                overrides=None, inspect=None):
    """Serve full-width models (bf16, random weights from seed 0) from one
    engine and one DeepRT through build_live_scheduler: per model a
    prefill category (seq 512, batch buckets 1-8) and a decode category
    (``decode_seq[mid]``), with ``streams[kind]`` streams each. Every
    stream's deadline is ``deadline_factor`` x the sum over the models of
    one decode step plus the largest prefill (profiled WCETs), its period
    half that. Checks admission of every category, conservation, zero
    decode and prefill captures after warm-up, that every kernel the
    models run was launched while serving, each model's prefill replays
    at batch 1 and 8 against the eager body (``prefill_graph_checks``),
    and well-formed outputs. Returns the served run's record and launch
    counts.

    ``chunk_depth`` > 1 builds the engine to serve decode chunks that deep
    (every depth profiled, and captured, in the warm-up), and adds per
    model one burst of 8 decode jobs of its decode category, submitted at
    one instant with a 30 s deadline, which the EDF worker fuses into
    chunks: each model must serve at least one chunk of 2 or more steps.

    ``overrides``: config overrides by model id (a depth cut).
    ``inspect(engine)``, if given, runs after the checks, before the
    device closes; its dict joins the returned record."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import Category, ChunkJob, Frame, JobInstance, Request
    from repro_torch.kernels import ops
    from repro_torch.serving.batcher_bridge import build_live_scheduler
    from repro_torch.serving.engine import InferenceEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"device memory allocated before the engine: {torch.cuda.memory_allocated()} bytes")
    cfgs = {mid: get_config(mid, **(overrides or {}).get(mid, {})) for mid in decode_seq}
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
    log(f"profiling (and captures: {graph_kinds(engine)}) took "
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
        f"prefill_compiles={engine.stats['prefill_compiles']} "
        f"chunk_submits={m.chunk_submits} chunked_steps={m.chunked_steps} "
        f"chunk_steps(engine)={engine.stats['chunk_steps']} chunks by model {chunks}")
    if m.completed_frames < 1:
        raise AssertionError("no frame completed")
    if m.completed_frames + m.dropped_frames + m.lost_frames != ingested:
        raise AssertionError("conservation: completed + dropped + lost != ingested")
    check_no_captures(engine, "served")
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
    needed |= {"ssd_chunk", "ssd_step"} if "mamba2" in kinds else set()
    needed.add("rownorm")  # every model normalises
    for name in sorted(needed):
        if serving_launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched while serving")

    # Every model's prefill replay equals its eager body, at batch 1 and 8.
    prefill_checks = {mid: prefill_graph_checks(torch, engine, mid, PREFILL_SEQ) for mid in cfgs}
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
    extra = inspect(engine) if inspect is not None else {}
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
        peak_reserved_bytes=torch.cuda.max_memory_reserved(), prefill_checks=prefill_checks,
        **extra,
    )


def graph_kinds(engine) -> dict:
    """The engine's captured step graphs, counted by kind."""
    kinds = [key[0] for key in engine._graphs]
    return {k: kinds.count(k) for k in ("decode", "prefill")}


def check_no_captures(engine, label):
    """Zero decode and zero prefill captures since the warm-up's
    ``reset_stats``."""
    st = engine.stats
    if st["decode_compiles"] or st["prefill_compiles"]:
        raise AssertionError(f"{label}: {st['decode_compiles']} decode and "
                             f"{st['prefill_compiles']} prefill captures after warm-up")


def prefill_graph_checks(torch, engine, mid, seq, batches=(1, 8)) -> dict:
    """For each batch bucket: one replay of the (mid, seq, b) prefill graph
    against the eager body on the same seeded tokens (the next tokens, bit
    for bit), and a ``last_logits`` step graph captured the same way
    against the eager logits (bit for bit). Returns each bucket's replay
    and eager enqueue ms (host clock, up to the dispatch's return) and
    the graph's launches; raises on a difference or a capture while
    checking."""
    from repro_torch.serving.engine import _StepGraph

    model, params = engine.models[mid], engine.params[mid]
    vocab = engine.configs[mid].vocab_size
    before = engine.stats["prefill_compiles"]
    out = {}
    for b in batches:
        graph = engine._graphs.get(("prefill", mid, seq, b))
        if graph is None:
            raise AssertionError(f"{mid}: no prefill graph for seq {seq} batch {b}")
        gen = torch.Generator().manual_seed(seq * 100 + b)
        toks = torch.randint(0, vocab, (b, seq), generator=gen, dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = engine.dispatch(mid, (seq,), b, "prefill", payload=toks.numpy())
        replay_ms = (time.perf_counter() - t0) * 1e3
        got = h.wait()
        dev = toks.to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (want,) = engine._prefill_fn(mid, seq, b)(dev)
        eager_ms = (time.perf_counter() - t0) * 1e3

        def logits(t):
            with torch.no_grad():
                return (model.last_logits(params, t),)

        lg_graph = _StepGraph(logits, (torch.zeros_like(dev),), engine._graph_pool)
        (got_lg,) = lg_graph.replay((dev,))
        got_lg = got_lg.clone()
        (want_lg,) = logits(dev)
        torch.cuda.synchronize()
        del lg_graph
        if not (torch.equal(got, want) and torch.equal(got_lg, want_lg)):
            diff = float((got_lg - want_lg).abs().max())
            raise AssertionError(f"{mid}: prefill replay vs eager body at batch {b} not "
                                 f"bit-identical (tokens equal {torch.equal(got, want)}, "
                                 f"logits max |diff| {diff:.3e})")
        if not bool(torch.isfinite(want_lg).all()):
            raise AssertionError(f"{mid}: non-finite prefill logits at batch {b}")
        out[b] = dict(replay_enqueue_ms=replay_ms, eager_enqueue_ms=eager_ms,
                      launches=dict(graph.launches))
        log(f"{mid} prefill seq {seq} batch {b}: replay = eager body bit for bit (tokens "
            f"{got.tolist()}, last-position logits); enqueue replay {replay_ms:.3f} ms, "
            f"eager {eager_ms:.3f} ms; launches per replay {graph.launches}")
    if engine.stats["prefill_compiles"] != before:
        raise AssertionError(f"{mid}: a prefill capture while checking")
    return out


# Kernel wrapper calls per decode step (the captured launches of one step
# replay), by model: granite's 40 attn layers; rwkv6's 24 rwkv layers;
# recurrentgemma's 12 swa and 26 rglru layers; mixtral's 16 swa layers
# (MOE_LAYERS); the zoo's attention layers at ZOO_LAYERS (gemma3's 40 swa
# and 8 attn).
CALLS_PER_STEP = {
    GEMMA3: {"decode_attention": 48, "flash_attention": 0, "wkv6": 0, "rglru_scan": 0},
    PHI4: {"decode_attention": 32, "flash_attention": 0, "wkv6": 0, "rglru_scan": 0},
    LLAMA3: {"decode_attention": 4, "flash_attention": 0, "wkv6": 0, "rglru_scan": 0},
    LLAMA4: {"decode_attention": 1, "flash_attention": 0, "wkv6": 0, "rglru_scan": 0},
    MID: {"decode_attention": 40, "flash_attention": 0, "wkv6": 0, "rglru_scan": 0},
    RWKV: {"decode_attention": 0, "flash_attention": 0, "wkv6": 24, "rglru_scan": 0},
    RGEMMA: {"decode_attention": 12, "flash_attention": 0, "wkv6": 0, "rglru_scan": 26},
    MIXTRAL: {"decode_attention": 16, "flash_attention": 0, "wkv6": 0, "rglru_scan": 0},
    GRANITE4H: {"decode_attention": 4, "flash_attention": 0, "wkv6": 0, "rglru_scan": 0,
                "ssd_step": 36},
}
for _calls in CALLS_PER_STEP.values():  # decode never runs a backward kernel
    _calls.update(flash_attention_bwd=0, wkv6_bwd=0, rglru_bwd=0, ssd_chunk=0)
    _calls.setdefault("ssd_step", 0)
    # One row-norm launch a norm: two a block (each block launches one of the
    # four mixers above) and the final norm, and Mamba-2's gated norm.
    _calls["rownorm"] = 2 * (_calls["decode_attention"] + _calls["wkv6"]
                             + _calls["rglru_scan"] + _calls["ssd_step"]) + 1 + _calls["ssd_step"]


SSD_SHAPE = dict(b=8, s=512, h=64, p=64, n=128)  # granite-4.0-h-micro's served prompt
SSD_DECODE_ROWS = 32  # the chat cells' arena


def ssd_chunk_inputs(torch, gen, b, s, h, p, n, dtype):
    """xbc and dt as the model hands them to ``ssd_chunk`` (views of one
    input projection), the conv's weights and granite-4.0-h-micro-like step
    sizes and decays."""
    cc = h * p + 2 * n
    proj = torch.randn((b, s, cc + h + 8), generator=gen, device="cuda").to(dtype)
    conv_w = (0.5 * torch.randn((4, cc), generator=gen, device="cuda")).to(dtype)
    conv_b = (0.1 * torch.randn(cc, generator=gen, device="cuda")).to(dtype)
    dt_bias = (torch.randn(h, generator=gen, device="cuda") - 3.0).to(dtype)
    a_log = (0.5 * torch.randn(h, generator=gen, device="cuda") + 1.0).to(dtype)
    d = (1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    return proj[..., :cc], conv_w, conv_b, proj[..., cc:cc + h], dt_bias, a_log, d


def ssd_step_inputs(torch, gen, rows, h, p, n, dtype):
    cc = h * p + 2 * n
    proj = torch.randn((rows, cc + h + 8), generator=gen, device="cuda").to(dtype)
    xbc, dt = proj[:, :cc], proj[:, cc:cc + h]
    conv = torch.randn((rows, 3, cc), generator=gen, device="cuda")
    conv_w = (0.5 * torch.randn((4, cc), generator=gen, device="cuda")).to(dtype)
    conv_b = (0.1 * torch.randn(cc, generator=gen, device="cuda")).to(dtype)
    dt_bias = (torch.randn(h, generator=gen, device="cuda") - 3.0).to(dtype)
    a_log = (0.5 * torch.randn(h, generator=gen, device="cuda") + 1.0).to(dtype)
    d = (1.0 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    state = torch.randn((rows, h, p, n), generator=gen, device="cuda")
    return xbc, dt, conv, conv_w, conv_b, dt_bias, a_log, d, state


def ssd_kernels(torch, report):
    """The two Mamba-2 kernels and the gated row norm against their plain
    twins, then timed alone at the served shapes.

    ``ssd_chunk``: bf16 at 8 x 512 (the served prompt), B 1 x 992 and
    2 x 100 (ragged chunks) and float32 at 2 x 130 against its twin
    ``ref.ssd_chunk_plain`` (the conv, then the chunked recurrence), y and
    the last state, and at 2 x 130 against the conv then the step-by-step
    ``ref.ssd_ref`` too; two calls equal. Timed at 8 x 512 and 4 x 512 as
    CUDA-graph replays over inputs past L2, beside the plain twin eager,
    against its bound (bytes: xBC and dt read, y written; operations
    5 H P N a token). ``ssd_step``: 32 rows, every
    other held, both dtypes, against ``ref.ssd_step_plain`` (y, the state,
    the conv window); held rows' states ``torch.equal`` to before; two
    calls equal; timed at 32 stepped rows against its bytes bound (each
    state read and written once), failing under 60% of it. The gated
    norm: 4096 rows of 4096 with a strided gate, both dtypes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rownorm as rn
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels import ssd_step as ss

    gen = torch.Generator(device="cuda").manual_seed(2468)
    sh = SSD_SHAPE
    h, p, n = sh["h"], sh["p"], sh["n"]
    errs = {}
    for dtype_name, b, s in (("bfloat16", 8, 512), ("bfloat16", 1, 992), ("bfloat16", 2, 100),
                             ("float32", 2, 130)):
        dtype = getattr(torch, dtype_name)
        args = ssd_chunk_inputs(torch, gen, b, s, h, p, n, dtype)
        y, last = sc.ssd_chunk(*args, state_size=n)
        want, want_last = ref.ssd_chunk_plain(*args, state_size=n)
        torch.cuda.synchronize()
        label = f"ssd_chunk {b} x {s} {dtype_name}"
        err = assert_close(label, y, want, TOL[dtype_name])
        err_s = assert_close(f"{label} last state", last, want_last, TOL[dtype_name])
        if dtype_name == "float32":
            xbc, conv_w, conv_b, dt, dt_bias, a_log, d = args
            x, bm, cm = ref.ssd_conv(xbc, conv_w, conv_b, h, n)
            seq_y, seq_last = ref.ssd_ref(x, dt, dt_bias, a_log, bm, cm, d)
            err = max(err, assert_close(f"{label} vs ssd_ref", y, seq_y, TOL[dtype_name]))
            assert_close(f"{label} last state vs ssd_ref", last, seq_last, TOL[dtype_name])
        y2, last2 = sc.ssd_chunk(*args, state_size=n)
        if not (torch.equal(y, y2) and torch.equal(last, last2)):
            raise AssertionError(f"{label}: two calls on the same inputs differ")
        errs[dtype_name] = max(errs.get(dtype_name, 0.0), err)
        log(f"{label}: max_abs_err y {err:.3e}, last state {err_s:.3e}")
    run_k = lambda *a: sc.ssd_chunk(*a, state_size=n, last_state=False)
    chunk = {}
    for b_ in (sh["b"], sh["b"] // 2):
        s_ = sh["s"]
        per = b_ * s_ * (h * p + 2 * n + h + 8) * 2
        inputs = [ssd_chunk_inputs(torch, gen, b_, s_, h, p, n, torch.bfloat16)
                  for _ in range(n_copies(per))]
        ms = device_ms(run_k, inputs)
        plain_ms = time_ms(lambda *a: ref.ssd_chunk_plain(*a, state_size=n), inputs[:2], iters=3,
                           warmup=1)
        nbytes = b_ * s_ * (2 * h * p + h + 2 * n) * 2
        bound_ms, bound_by = bound(nbytes, 5 * b_ * s_ * h * p * n)
        chunk[b_] = (ms, plain_ms, bound_ms, bound_by)
        log(f"ssd_chunk timed {b_} x {s_} bf16 (no last state): kernel {ms:.4f} ms, plain "
            f"twin eager {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
            f"({100 * bound_ms / ms:.1f}% of it); kernels "
            + json.dumps({k: round(v, 4) for k, v in
                          launch_split(torch, run_k, inputs[:1]).items()}))
    b_, s_ = sh["b"], sh["s"]
    chunk_ms, plain_ms, chunk_bound, chunk_by = chunk[b_]

    rows = SSD_DECODE_ROWS
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        xbc, dt, conv, conv_w, conv_b, dt_bias, a_log, d, state = ssd_step_inputs(
            torch, gen, rows, h, p, n, dtype)
        active = torch.arange(rows, device="cuda") % 2 == 0
        held = ~active
        conv_p, state_p = conv.clone(), state.clone()
        conv0, state0 = conv.clone(), state.clone()
        y = ss.ssd_step(xbc, dt, conv, conv_w, conv_b, dt_bias, a_log, d, state, active)
        want = ref.ssd_step_plain(xbc, dt, conv_p, conv_w, conv_b, dt_bias, a_log, d, state_p,
                                  active)
        torch.cuda.synchronize()
        label = f"ssd_step {rows} rows {dtype_name}"
        err = assert_close(label, y, want, TOL[dtype_name])
        assert_close(f"{label} state", state, state_p, TOL[dtype_name])
        assert_close(f"{label} conv window", conv, conv_p, TOL[dtype_name])
        if not (torch.equal(state[held], state0[held]) and torch.equal(conv[held], conv0[held])
                and float(y[held].abs().max()) == 0.0):
            raise AssertionError(f"{label}: a held row was touched")
        conv_r, state_r = conv0.clone(), state0.clone()
        y_r = ss.ssd_step(xbc, dt, conv_r, conv_w, conv_b, dt_bias, a_log, d, state_r, active)
        if not (torch.equal(y, y_r) and torch.equal(state, state_r) and torch.equal(conv, conv_r)):
            raise AssertionError(f"{label}: two calls on the same inputs differ")
        errs[dtype_name] = max(errs[dtype_name], err)
        log(f"{label}: max_abs_err {err:.3e}; held rows untouched")
    every = torch.ones(rows, dtype=torch.bool, device="cuda")
    step_inputs = [ssd_step_inputs(torch, gen, rows, h, p, n, torch.bfloat16) + (every,)
                   for _ in range(n_copies(rows * h * p * n * 4))]
    step_ms = device_ms(lambda *a: ss.ssd_step(*a), step_inputs)
    cc = h * p + 2 * n
    step_bytes = rows * (2 * h * p * n * 4 + 2 * 3 * cc * 4 + (cc + h + h * p) * 2) + 5 * cc * 2
    step_bound, step_by = bound(step_bytes, 5 * rows * h * p * n)
    share = step_bound / step_ms
    log(f"ssd_step timed {rows} rows bf16: kernel {step_ms:.4f} ms, bound {step_bound:.4f} ms by "
        f"{step_by} ({100 * share:.1f}% of it; {step_bytes} bytes)")
    if share < 0.6:
        raise AssertionError(f"ssd_step: {100 * share:.1f}% of its bytes bound at {rows} rows")

    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        proj = torch.randn((4096, 2 * h * p + 64), generator=gen, device="cuda").to(dtype)
        y = torch.randn((4096, h * p), generator=gen, device="cuda").to(dtype)
        w = (0.1 * torch.randn(h * p, generator=gen, device="cuda")).to(dtype)
        z = proj[:, : h * p]
        got = rn.rownorm(y, w, eps=1e-5, center=False, gate=z)
        want = rn.rownorm_plain(y, w, eps=1e-5, center=False, gate=z)
        err = assert_close(f"gated rownorm 4096 x {h * p} {dtype_name}", got, want,
                           TOL[dtype_name])
        log(f"gated rownorm 4096 x {h * p} {dtype_name}: max_abs_err {err:.3e}")
    report["ssd_chunk"] = dict(
        name="ssd_chunk", route="cuda", source="src/repro_torch/kernels/csrc/ssd_chunk.cu",
        replaces="none (the JAX package has no Mamba-2 block)",
        max_abs_err=errs["bfloat16"], f32_max_abs_err=errs["float32"], ms=chunk_ms,
        plain_ms=plain_ms, bound_ms=chunk_bound, bound_by=chunk_by, b4_ms=chunk[b_ // 2][0],
        b4_bound_ms=chunk[b_ // 2][2],
        shape=f"B {b_} x S {s_}, H {h}, P {p}, N {n}, bf16", library_ms=None)
    report["ssd_step"] = dict(
        name="ssd_step", route="cuda", source="src/repro_torch/kernels/csrc/ssd_step.cu",
        replaces="none (the JAX package has no Mamba-2 block)",
        max_abs_err=errs["bfloat16"], f32_max_abs_err=errs["float32"], ms=step_ms,
        bound_ms=step_bound, bound_by=step_by, bound_share=share,
        shape=f"{rows} rows, H {h}, P {p}, N {n}, bf16", library_ms=None)


def phase_hybrid(torch, report):
    """granite-4.0-h-micro: its kernels (``ssd_kernels``), one period of
    ten layers at full width in float32, kernel path against dense
    (``phase_model``), the 40-layer step graph (``phase_graphs``: replay =
    eager, a chunk = its steps, launches per replay), then served alone at
    full width and depth (``phase_serve``: both Mamba-2 kernels launched,
    prefill replays against their eager bodies)."""
    ssd_kernels(torch, report)
    phase_model(torch, GRANITE4H, 10)
    phase_graphs(torch, GRANITE4H, DECODE_SEQ[MID])
    served = phase_serve(torch, {GRANITE4H: DECODE_SEQ[MID]}, {"decode": 4, "prefill": 2},
                         frames=20, deadline_factor=12.0)
    log("served hybrid: " + json.dumps(served, sort_keys=True))



def phase_graphs(torch, mid, seq, k=8, **overrides):
    """One model at full width (bf16, 8 arena rows, seq ``seq``) with its
    decode step and k-step chunk as CUDA graphs. Scattered rows are
    leased at mixed cursors; the arena is snapshot, one k-step chunk runs
    with per-step row subsets (one step empty), the arena is restored IN
    PLACE, and the same k steps run as single-step replays: every arena
    leaf, the cursors, the active bitmap and each step's logits must agree
    bit for bit. Also: one step replay against the eager step on the same
    arena (restored again), bit for bit too, the arena's storage
    unchanged, and each graph's launches per replay against
    CALLS_PER_STEP. ``overrides`` go to the config (a depth cut)."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serving.engine import InferenceEngine

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config(mid, **overrides)
    engine = InferenceEngine({mid: cfg}, seed=0, max_slots=8, chunk_depth=k, device="cuda")
    arena = engine.arena(mid, seq)
    leaves = lambda: tree_leaves(arena.cache) + [arena.cur, arena.active]
    ptrs = [t.data_ptr() for t in leaves()]
    before = ops.launch_counts()
    engine.execute(mid, (seq,), 8, "decode")  # eager step, then its capture
    eager = {n: c - before[n] for n, c in ops.launch_counts().items()}
    engine.execute_chunk(mid, (seq,), 8, k)
    step_g = engine._graphs[("decode", mid, seq)]
    want = CALLS_PER_STEP[mid]
    if eager != want or step_g.launches != want:
        raise AssertionError(f"{mid}: launches per step eager {eager}, "
                             f"captured {step_g.launches}, expected {want}")
    # A chunk replays the step graph k times: one capture per (mid, seq).
    if list(engine._graphs) != [("decode", mid, seq)] or engine.stats["decode_compiles"] != 1:
        raise AssertionError(f"{mid}: graphs {list(engine._graphs)}, captures "
                             f"{engine.stats['decode_compiles']}; want the step graph alone")
    chunk_launches = {n: k * c for n, c in want.items()}
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
    if ops.launch_counts() != chunk_launches:
        raise AssertionError(f"{mid}: chunk replay counted {ops.launch_counts()}")
    after_chunk = [t.clone() for t in leaves()]
    for t, s in zip(leaves(), snap):
        t.copy_(s)
    ops.reset_launch_counts()
    steps = [engine.dispatch(mid, (seq,), len(live), "decode", slots=live,
                             payload=payloads[i], step_rows=rows_plan[i]).wait()
             for i in range(k)]
    if ops.launch_counts() != chunk_launches:
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

    replay_vs_eager(torch, engine, mid, seq, {r: payloads[0].get(r, 0) for r in live})
    if [t.data_ptr() for t in leaves()] != ptrs:
        raise AssertionError(f"{mid}: the arena's storage moved")
    log(f"graphs {mid} seq {seq}: k={k} chunk vs {k} single replays bit-identical "
        f"(rows {live}, steps {rows_plan}); replay vs eager step bit-identical "
        f"(logits and every arena leaf); launches per step replay "
        f"{step_g.launches}, per chunk {chunk_launches}; arena storage unchanged; "
        f"decode_compiles {engine.stats['decode_compiles']}; eager step + captures "
        f"{captured_s:.3f} s")
    del engine, snap, after_chunk, chunk, steps
    gc.collect()
    torch.cuda.empty_cache()


def replay_vs_eager(torch, engine, mid, seq, payload):
    """One step replay of the (mid, seq) graph on the leased rows of
    ``payload`` (row -> token) against the eager step on the same arena
    (snapshot, then restored in place): the live rows' logits and every
    arena leaf, bit for bit."""
    from repro_torch.models.layers import tree_leaves

    arena = engine.arena(mid, seq)
    leaves = lambda: tree_leaves(arena.cache) + [arena.cur, arena.active]
    live = sorted(payload)
    snap = [t.clone() for t in leaves()]
    cur, active = arena.cur.clone(), arena.active.clone()
    tok = torch.zeros(engine.max_slots, dtype=torch.int32, device="cuda")
    tok[live] = torch.tensor([payload[r] for r in live], dtype=torch.int32, device="cuda")
    replay = engine.dispatch(mid, (seq,), len(live), "decode", slots=live,
                             payload=dict(payload)).wait()
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
    if not bool(torch.isfinite(replay[live]).all()):
        raise AssertionError(f"{mid}: non-finite replay logits")


# ---------------------------------------------------------------------------
# live clusters: cluster, faults, gateway
# ---------------------------------------------------------------------------
# Each slice's streams get a deadline of CLUSTER_DEADLINE_FACTOR x (decode
# WCET + batch-8 prefill WCET), the largest over the slices, and a period
# of half that: one frame a stream per DisBatcher window.
CLUSTER_DEADLINE_FACTOR = 8.0
# The watchdog's deadline floor for full-width granite: 12x a decode step
# (about 8 ms on the card, up to 18 ms host-inclusive) and above a
# batch-1 prefill's WCET times the slack, so host noise never reads as
# lateness; a wedge is declared hung after hang_slack / slack = 3 floors.
WATCHDOG_MIN_DEADLINE = 0.1


def granite_cluster(torch, names, transport=False, **kw):
    """Full-width granite-3-2b on len(names) slices of one card: each its
    own engine (seeded weights, a 2048-seq decode arena), profiled alone,
    with a Phase-1 bound of 1 / len(names) so the slices' admissions
    together claim the card once. Returns (cluster, slices, cats,
    deadline), and with ``transport`` (build_live_transport; ``kw`` goes
    to it) also the gateway, the transport server and the UDP binding."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.batcher_bridge import build_live_cluster, build_live_transport

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dec = (DECODE_SEQ[MID],)
    cats = [(MID, (PREFILL_SEQ,), "prefill"), (MID, dec, "decode")]
    t0 = time.perf_counter()
    build = build_live_transport if transport else build_live_cluster
    built = build(
        {MID: get_config(MID)}, cats, slice_names=names, batch_sizes=(1, 2, 4, 8),
        utilization_bounds={n: 1.0 / len(names) for n in names}, device="cuda", **kw)
    cluster, slices = built[:2]
    torch.cuda.synchronize()
    worst = 0.0
    for name, sl in slices.items():
        t, e = sl.spec.table, sl.engine
        w_dec = t.wcet(MID, dec, e.max_slots)
        w_pre = {b: t.wcet(MID, (PREFILL_SEQ,), b) for b in (1, 2, 4, 8)}
        worst = max(worst, w_dec + w_pre[8])
        chunks = ""
        if t.has_chunks(MID, dec):
            chunks = "; chunks " + ", ".join(
                f"k={k}: {t.chunk_wcet(MID, dec, k) * 1e3:.3f} ms"
                for k in t.chunk_depths_profiled(MID, dec))
        log(f"slice {name}: {e.max_slots} arena rows ({e.arena_nbytes(MID, dec[0])} bytes), "
            f"graphs {graph_kinds(e)}; profiled WCET decode {w_dec * 1e3:.3f} ms, "
            "prefill " + ", ".join(f"b{b}: {w * 1e3:.3f} ms" for b, w in w_pre.items())
            + chunks)
    deadline = CLUSTER_DEADLINE_FACTOR * worst
    log(f"{len(names)} slices built and profiled in {time.perf_counter() - t0:.3f} s; "
        f"device memory {torch.cuda.memory_allocated()} bytes (peak "
        f"{torch.cuda.max_memory_allocated()}); stream deadline {deadline * 1e3:.3f} ms")
    return (cluster, slices, cats, deadline) + tuple(built[2:])


def register_streams(gateway, cfg, deadline, n_decode, n_prefill, seed, frames):
    """Camera decode streams (one scalar token a frame) and prefill
    streams (512 tokens a frame) whose bytes come from seeded sources."""
    from repro_torch.core import Category
    from repro_torch.ingest import CameraSource

    sessions = []
    for i in range(n_decode + n_prefill):
        decode = i < n_decode
        src = CameraSource(period=deadline / 2, n_frames=frames,
                           payload_shape=() if decode else (PREFILL_SEQ,),
                           vocab=cfg.vocab_size, seed=seed + i)
        shape = (DECODE_SEQ[MID],) if decode else (PREFILL_SEQ,)
        sessions.append(gateway.register(src, Category(MID, shape), relative_deadline=deadline))
    if any(s.state != "active" for s in sessions):
        raise AssertionError(f"sessions not all admitted: {[s.state for s in sessions]}")
    return sessions


def check_conserved(cluster, label):
    agg = cluster.aggregate_metrics()
    if agg["completed_frames"] + agg["dropped_frames"] + agg["lost_frames"] != agg[
            "ingested_frames"]:
        raise AssertionError(f"{label}: conservation broken: {agg}")
    if cluster.parked:
        raise AssertionError(f"{label}: parked tails left unresolved: {cluster.parked}")
    return agg


def check_accounted(cluster, victims, label):
    """Each displaced request in exactly one ledger; returns the ledgers."""
    ledgers = {}
    for rid in victims:
        kinds = []
        if rid in cluster.finished_with_slice:
            kinds.append("finished_with_slice")
        if rid in cluster.failover_map:
            if rid in cluster.parked_expired:
                kinds.append("parked_expired")
            elif rid in cluster.parked_admitted:
                kinds.append("parked_admitted")
            elif cluster.failover_map[rid] is not None:
                kinds.append("failover_map")
        if any(r.request_id == rid for r in cluster.dropped):
            kinds.append("dropped")
        if len(kinds) != 1:
            raise AssertionError(f"{label}: request {rid} in ledgers {kinds}")
        ledgers[kinds[0]] = ledgers.get(kinds[0], 0) + 1
    return ledgers


def check_survivors(slices, dead, label):
    for name, sl in slices.items():
        if name == dead:
            continue
        check_no_captures(sl.engine, f"{label}: survivor {name}")
        if graph_kinds(sl.engine)["decode"] != 1:
            raise AssertionError(f"{label}: survivor {name} graphs {list(sl.engine._graphs)}")
        if sl.leases:
            raise AssertionError(f"{label}: survivor {name} kept leases {sl.leases}")


def check_dead_engine(engine, label):
    """Every later touch of a failed slice's engine raises."""
    dec = DECODE_SEQ[MID]
    for op in (lambda: engine.dispatch(MID, (dec,), 1, "decode"),
               lambda: engine.dispatch(MID, (PREFILL_SEQ,), 1, "prefill"),
               lambda: engine.decode_chunk(MID, (dec,), 1, 1),
               lambda: engine.alloc_slots(MID, dec, 1),
               lambda: engine.free_slots(MID, dec, [0])):
        try:
            op()
        except RuntimeError as e:
            if "frozen" not in str(e):
                raise
        else:
            raise AssertionError(f"{label}: the failed slice's engine accepted a touch")


def check_launches(ops, label):
    used = ops.launch_counts()
    for name in ("decode_attention", "flash_attention"):
        if used[name] < 1:
            raise AssertionError(f"{label}: kernel {name} was not launched while serving")
    return used


def close_cluster(torch, cluster, slices):
    """Stop every slice's device (their waiter threads hold the engines)
    and drop the engines."""
    for sl in slices.values():
        sl.scheduler.device.close()
    peak = torch.cuda.max_memory_allocated()
    slices.clear()
    cluster.slices.clear()
    cluster.telemetry_probes.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def cluster_summary(cluster, slices):
    agg = cluster.aggregate_metrics()
    return dict(
        completed=agg["completed_frames"], missed=agg["missed_frames"],
        dropped=agg["dropped_frames"], lost=agg["lost_frames"],
        ingested=agg["ingested_frames"], e2e_p99_ms=agg["e2e_p99"] * 1e3,
        reroutes=agg["reroutes"],
        per_slice={n: dict(health=sl.health, completed=sl.scheduler.metrics.completed_frames,
                           missed=sl.scheduler.metrics.missed_frames,
                           p99_ms=sl.scheduler.metrics.latency_percentile(0.99) * 1e3,
                           decode_wcet_ms=sl.spec.table.wcet(
                               MID, (DECODE_SEQ[MID],), sl.engine.max_slots) * 1e3,
                           dispatches=sl.engine.stats["dispatches"],
                           decode_compiles=sl.engine.stats["decode_compiles"],
                           prefill_compiles=sl.engine.stats["prefill_compiles"])
                   for n, sl in slices.items()},
    )


def phase_cluster(torch):
    """Three slices on one WallClock; decode streams (2048-seq arena rows
    leased per stream, real tokens) and prefill streams (512 tokens)
    through the gateway; one slice is killed mid-decode with fail_slice."""
    from repro_torch.configs.registry import get_config
    from repro_torch.ingest import IngestGateway
    from repro_torch.kernels import ops

    names = ("slice0", "slice1", "slice2")
    cluster, slices, _, deadline = granite_cluster(torch, names)
    gw = IngestGateway(cluster)
    sessions = register_streams(gw, get_config(MID), deadline, n_decode=6, n_prefill=3,
                                seed=100, frames=12)
    by_slice = {}
    for rid, name in cluster.placement.items():
        by_slice.setdefault(name, []).append(rid)
    log("placement: " + ", ".join(f"{n}: {len(r)}" for n, r in sorted(by_slice.items())))
    ops.reset_launch_counts()
    cluster.run(until=cluster.loop.now + 3.2 * deadline / 2)
    dead = max(by_slice, key=lambda n: (len(by_slice[n]), n))
    victims = list(by_slice[dead])
    now = cluster.loop.now
    if not any(cluster.requests[r].end_time > now for r in victims):
        raise AssertionError("cluster: the failed slice holds no stream mid-decode")
    dead_engine = slices[dead].engine
    completed_at_failure = cluster.aggregate_metrics()["completed_frames"]
    parked_now = cluster.fail_slice(dead)
    dead_stats = dict(dead_engine.stats)
    cluster.run()
    torch.cuda.synchronize()
    used = check_launches(ops, "cluster")
    agg = check_conserved(cluster, "cluster")
    ledgers = check_accounted(cluster, victims, "cluster")
    if len(cluster.parked_admitted) + len(cluster.parked_expired) != len(parked_now):
        raise AssertionError("cluster: parked tails not all resolved")
    if agg["completed_frames"] <= completed_at_failure:
        raise AssertionError("cluster: nothing completed after the failure")
    if sum(1 for t in cluster.failover_map.values() if t is not None) < 1:
        raise AssertionError("cluster: no tail was re-admitted")
    check_survivors(slices, dead, "cluster")
    check_dead_engine(dead_engine, "cluster")
    if dict(dead_engine.stats) != dead_stats:
        raise AssertionError("cluster: the failed slice's engine moved after the failure")
    if any(s.state not in ("active", "failover") or not s.conserved() for s in sessions):
        raise AssertionError(f"cluster: sessions {[(s.state, s.conserved()) for s in sessions]}")
    summary = cluster_summary(cluster, slices)
    summary.update(failed=dead, victims=len(victims), ledgers=ledgers,
                   parked_at_failure=len(parked_now), launches=used)
    summary["peak_mem_bytes"] = close_cluster(torch, cluster, slices)
    log("cluster: " + json.dumps(summary, sort_keys=True))


def phase_faults(torch):
    """Three slices with the watchdog armed: slice0's decode wedges on its
    third served submit (its waiter blocks on a handle that never
    resolves), slice1 is throttled on three spaced submits to the larger
    of 4x its WCET and WCET + 0.16 s (past every deadline, WCET x 3 or
    the 0.1 s floor, short of every hang, 3x the deadline), slice2 is
    clean. Nothing but the watchdog acts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import DELAY, QUARANTINED, STALL, FaultPlan, FaultSpec, WatchdogConfig
    from repro_torch.ingest import IngestGateway
    from repro_torch.kernels import ops

    wd = WatchdogConfig(slack=3.0, hang_slack=9.0, min_deadline=WATCHDOG_MIN_DEADLINE,
                        suspect_after=2, quarantine_after=6)
    plans = {"slice0": FaultPlan((FaultSpec(STALL, 2),)),
             "slice1": FaultPlan(tuple(FaultSpec(DELAY, i, factor=4.0, extra=0.16)
                                       for i in (2, 6, 10)))}
    names = ("slice0", "slice1", "slice2")
    cluster, slices, _, deadline = granite_cluster(torch, names, watchdog=wd, fault_plans=plans)
    log(f"watchdog: slack {wd.slack}, hang_slack {wd.hang_slack}, min_deadline "
        f"{wd.min_deadline} s (decode deadline {wd.deadline_for(0.008):.3f} s, hung after "
        f"{wd.hang_after(0.008):.3f} s)")
    gw = IngestGateway(cluster)
    sessions = register_streams(gw, get_config(MID), deadline, n_decode=6, n_prefill=3,
                                seed=200, frames=12)
    victims = [rid for rid, n in cluster.placement.items() if n == "slice0"]
    if not victims:
        raise AssertionError("faults: nothing placed on the slice that wedges")
    ops.reset_launch_counts()
    horizon = 12 * deadline / 2 + 5.0
    cluster.run(until=cluster.loop.now + horizon)
    torch.cuda.synchronize()
    used = check_launches(ops, "faults")
    dead = slices["slice0"]
    quarantines = [(t, r) for t, n, _o, new, r in cluster.health.transitions
                   if n == "slice0" and new == QUARANTINED]
    if dead.health != QUARANTINED or dead.alive or not quarantines or "hung" not in quarantines[0][1]:
        raise AssertionError(f"faults: slice0 not quarantined as hung: {cluster.health.transitions}")
    stall_t = next(t for _i, kind, t in dead.device.injected if kind == STALL)
    detect_s = quarantines[0][0] - stall_t
    throttled = [(o, n_) for _t, n, o, n_, _r in cluster.health.transitions if n == "slice1"]
    slow = slices["slice1"].device
    if not slices["slice1"].alive or not throttled:
        raise AssertionError(f"faults: throttled slice1 transitions {throttled}, alive "
                             f"{slices['slice1'].alive}, submits {slow.submits}, "
                             f"injected {slow.injected}")
    agg = check_conserved(cluster, "faults")
    ledgers = check_accounted(cluster, victims, "faults")
    check_survivors(slices, "slice0", "faults")
    check_dead_engine(dead.engine, "faults")
    if not dead.device.inner.closed:
        raise AssertionError("faults: the wedged slice's device is open")
    if any(not s.conserved() for s in sessions):
        raise AssertionError("faults: a session lost count of its frames")
    summary = cluster_summary(cluster, slices)
    summary.update(stall_to_quarantine_ms=detect_s * 1e3, ledgers=ledgers,
                   transitions=[(round(t, 6), n, o, w, r)
                                for t, n, o, w, r in cluster.health.transitions],
                   reprofiles=dict(cluster.health.reprofiles), launches=used,
                   wedged_waiter=dead.device.inner.wedged,
                   throttled_submits=[i for i, _k, _t in slow.injected],
                   session_states=[s.state for s in sessions])
    summary["peak_mem_bytes"] = close_cluster(torch, cluster, slices)
    log(f"faults: stall to quarantine {detect_s * 1e3:.3f} ms; " + json.dumps(summary,
                                                                            sort_keys=True))


def spy_dispatches(slices):
    """Record (leases at dispatch, job, handle) per slice, in dispatch order."""
    captured = {name: [] for name in slices}
    for name, sl in slices.items():
        inner = sl.device.dispatch_fn

        def spy(job, _inner=inner, _sl=sl, _out=captured[name]):
            leases = {rid: lease[2][0] for rid, lease in _sl.leases.items()}
            handle = _inner(job)
            _out.append((leases, job, handle))
            return handle

        sl.device.dispatch_fn = spy
    return captured


def stream_steps(captured, rid):
    """(row, staged token, logits row) of every decode step in which
    stream ``rid`` had a frame (the earliest frame's token is staged)."""
    import numpy as np

    from repro_torch.core import ChunkJob

    steps = []
    for leases, job, handle in captured:
        if rid not in leases:
            continue
        out = handle.wait()
        members = job.jobs if isinstance(job, ChunkJob) else [job]
        for i, member in enumerate(members):
            frames = [f for f in member.frames if f.request_id == rid]
            if frames:
                logits = out[i] if isinstance(job, ChunkJob) else out
                row = leases[rid]
                steps.append((row, int(np.asarray(frames[0].payload)), logits[row]))
    return steps


def twin_replay_equal(torch, twin, steps):
    """Replay one stream's steps in its row on ``twin`` (an engine of the
    same max_slots, no other stream); every step's logits row must be
    bit-equal to the served one."""
    seq = DECODE_SEQ[MID]
    row = steps[0][0]
    twin.alloc_slots(MID, seq, row + 1)
    if row:
        twin.free_slots(MID, seq, list(range(row)))
    for i, (r, tok, served) in enumerate(steps):
        if r != row:
            raise AssertionError("gateway: a stream changed rows")
        got = twin.dispatch(MID, (seq,), 1, "decode", slots=[row], payload={row: tok}).wait()
        if not torch.equal(got[row], served):
            diff = float((got[row].float() - served.float()).abs().max())
            raise AssertionError(f"gateway: step {i} of a stream in row {row} differs from "
                                 f"its twin replay (max |diff| {diff:.3e})")
    twin.free_slots(MID, seq, [row])
    return len(steps)


def phase_gateway(torch):
    """The ingest gateway over two granite slices with chunk_depth=8: a
    camera decode stream and a bursty decode stream (12-frame bursts at
    twice the declared rate: a window holding more frames than arena rows
    sheds the excess) per slice, a prefill stream, and a reconnecting
    client's backlog of 8 leased frames submitted at one instant, which
    the EDF worker fuses into chunks on the slot-aware chunk path."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.core import Category, ChunkJob, Frame, JobInstance, Request
    from repro_torch.ingest import BurstSource, CameraSource, IngestGateway
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config(MID)
    names = ("slice0", "slice1")
    cluster, slices, _, deadline = granite_cluster(torch, names, chunk_depth=8)
    captured = spy_dispatches(slices)
    gw = IngestGateway(cluster)
    dec = Category(MID, (DECODE_SEQ[MID],))
    period = deadline / 2
    sessions = [gw.register(CameraSource(period=period, n_frames=10, payload_shape=(),
                                         vocab=cfg.vocab_size, seed=300 + i), dec,
                            relative_deadline=deadline) for i in range(2)]
    sessions += [gw.register(BurstSource(period=period, n_frames=24, burst=12, duty=0.5,
                                         intra_frac=0.125, payload_shape=(),
                                         vocab=cfg.vocab_size, seed=310 + i), dec,
                             relative_deadline=deadline) for i in range(2)]
    sessions.append(gw.register(CameraSource(period=period, n_frames=6,
                                             payload_shape=(PREFILL_SEQ,),
                                             vocab=cfg.vocab_size, seed=320),
                                Category(MID, (PREFILL_SEQ,)), relative_deadline=deadline))
    early = gw.register(CameraSource(period=period, n_frames=10, payload_shape=(),
                                     vocab=cfg.vocab_size, seed=330), dec,
                        relative_deadline=deadline)
    if any(s.state != "active" for s in sessions + [early]):
        raise AssertionError(f"gateway: sessions {[s.state for s in sessions + [early]]}")
    backlog = Request(category=dec, period=period, relative_deadline=deadline, n_frames=8)
    if not cluster.submit_request(backlog, external_arrivals=True):
        raise AssertionError("gateway: the backlog stream was not admitted")
    home = slices[cluster.placement[backlog.request_id]]
    toks = np.random.default_rng(340).integers(0, cfg.vocab_size, size=8).astype(np.int32)

    def reconnect():
        now = cluster.loop.now
        for i, tok in enumerate(toks):
            home.scheduler.metrics.record_ingest()
            f = Frame(request_id=backlog.request_id, category=dec, index=i, arrival_time=now,
                      deadline=now + 30.0, payload=tok)
            home.scheduler.worker.submit(JobInstance(category=dec, frames=[f],
                                                     release_time=now,
                                                     relative_deadline=30.0,
                                                     shape_key=dec.shape_key))

    def close_early():
        sl = slices[early.slice_name]
        gw.close(early)
        if early.request_id in sl.leases:
            raise AssertionError("gateway: closing a stream kept its lease")

    cluster.loop.schedule(cluster.loop.now + 1.5 * period, reconnect)
    cluster.loop.schedule(cluster.loop.now + 4.5 * period, close_early)
    ops.reset_launch_counts()
    cluster.run()
    torch.cuda.synchronize()
    used = check_launches(ops, "gateway")
    agg = check_conserved(cluster, "gateway")
    chunks = [job.k for cap in captured.values() for _, job, _ in cap
              if isinstance(job, ChunkJob)]
    if not chunks or max(chunks) < 2:
        raise AssertionError(f"gateway: no burst fused into a chunk of 2 or more: {chunks}")
    # Shed frames, three ways: the sessions, each slice's metrics and its
    # adaptation module; every lease released (the shedder advanced the
    # countdowns of truncated streams).
    shed_sessions = sum(s.frames_dropped for s in sessions + [early])
    shed_metrics = sum(sl.scheduler.metrics.dropped_frames for sl in slices.values())
    shed_adapt = sum(sum(sl.scheduler.adaptation.sheds.values()) for sl in slices.values())
    if not shed_sessions == shed_metrics == shed_adapt > 0:
        raise AssertionError(f"gateway: shed frames {shed_sessions} (sessions), "
                             f"{shed_metrics} (metrics), {shed_adapt} (adaptation)")
    if early.state != "closed" or any(s.state != "active" for s in sessions):
        raise AssertionError("gateway: session states")
    if not all(s.conserved() for s in sessions + [early]):
        raise AssertionError("gateway: a session lost count of its frames")
    for sl in slices.values():
        if sl.leases or any(len(a.free) != a.max_slots for a in sl.engine._arenas.values()):
            raise AssertionError(f"gateway: {sl.spec.name} kept leases {sl.leases}")
    check_survivors(slices, None, "gateway")
    # Leased-row logits, bit for bit, against a twin engine of the same
    # max_slots (sharing the slice's weights) replaying one stream alone.
    checked = {}
    for name, sl in slices.items():
        twin = InferenceEngine({MID: cfg}, max_slots=sl.engine.max_slots, device="cuda",
                               params=sl.engine.params)
        streams = [(f"camera {s.request_id}", s.request_id) for s in sessions[:2]
                   if s.slice_name == name]
        streams += [(f"burst {s.request_id}", s.request_id) for s in sessions[2:4]
                    if s.slice_name == name]
        if sl is home:
            streams.append(("backlog", backlog.request_id))
        for label, rid in streams:
            steps = stream_steps(captured[name], rid)
            if steps:
                checked[f"{name} {label}"] = twin_replay_equal(torch, twin, steps)
        del twin
    if "backlog" not in " ".join(checked) or sum(1 for k in checked if "camera" in k) < 1:
        raise AssertionError(f"gateway: twin replays {checked}")
    summary = cluster_summary(cluster, slices)
    summary.update(chunks=chunks, shed=shed_sessions, launches=used, twin_steps=checked,
                   collisions=sum(sl.scheduler.metrics.payload_collisions
                                  for sl in slices.values()),
                   chunk_steps={n: sl.engine.stats["chunk_steps"] for n, sl in slices.items()})
    captured.clear()
    summary["peak_mem_bytes"] = close_cluster(torch, cluster, slices)
    log("gateway: leased rows bit-equal to twin replays " + json.dumps(checked)
        + "; " + json.dumps(summary, sort_keys=True))


# The chaos mix of the reference's transport robustness replay
# (benchmarks/transport_robustness.py): per-send drop, duplicate, reorder
# and delay probabilities, each link's plan from its own seed.
LINK_SEED = 2026
CHAOS = dict(p_drop=0.06, p_dup=0.06, p_reorder=0.08, p_delay=0.06, reorder_hold=(0.05, 0.2))


def transport_counts(transport, clients):
    """Wire outcomes summed over the sessions."""
    tss = list(transport.sessions.values())
    return dict(
        delivered=sum(ts.delivered for ts in tss),
        dropped=sum(ts.shed + ts.late_rejected for ts in tss),
        lost=sum(ts.net_lost + ts.lost_to_slice for ts in tss),
        refused=sum(ts.refused for ts in tss), duplicates=sum(ts.duplicates for ts in tss),
        evicted=sum(ts.evicted for ts in tss),
        credits=sum(c.credits_seen for c in clients),
        retransmits=sum(c.retransmits for c in clients))


def udp_arm(cluster, transport, binding, deadline, frames=6):
    """One decode stream's frames over UdpClientLink -> UdpServerBinding on
    127.0.0.1 (port 0): the HELLO/HELLO_ACK handshake, then the frames,
    with the loop on a thread of its own (the sockets' threads post into
    it). Returns the session and its source."""
    import threading

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.core import Category
    from repro_torch.ingest import CameraSource, TransportSource, UdpClientLink

    loop = cluster.loop
    link = UdpClientLink(loop, binding.addr)
    loop.hold()
    runner = threading.Thread(target=loop.run, daemon=True)
    runner.start()
    try:
        src = CameraSource(period=deadline / 2, n_frames=frames, payload_shape=(),
                           vocab=get_config(MID).vocab_size, seed=600)
        client = TransportSource(src, Category(MID, (DECODE_SEQ[MID],)), deadline, link)
        sid, ok = link.handshake(client, timeout=5.0)
        if not ok:
            raise AssertionError(f"transport: UDP handshake refused (sid {sid})")
        client.start_remote(sid)
        limit = time.time() + frames * deadline + 30.0
        while time.time() < limit and len(transport.sessions[sid].seen) < frames:
            time.sleep(0.02)
        loop.post(transport.finalize_all)
        while time.time() < limit and not transport.sessions[sid].finalized:
            time.sleep(0.02)
        ts = transport.sessions[sid]
        if not ts.finalized or ts.delivered_log != list(range(frames)):
            raise AssertionError(f"transport: UDP session delivered {ts.delivered_log} "
                                 f"(finalized {ts.finalized})")
        for seq, payload in ts.delivered_payloads.items():
            if not np.array_equal(payload, src.payload(seq)):
                raise AssertionError(f"transport: UDP frame {seq} differs from its source")
        if not ts.wire_conserved() or not binding._thread.is_alive():
            raise AssertionError("transport: UDP session not conserved or rx thread down")
        return ts, src
    finally:
        link.close()
        binding.close()
        loop.release()
        runner.join(timeout=10.0)
        if runner.is_alive():
            raise AssertionError("transport: the loop thread did not stop")


def phase_transport(torch):
    """The datagram transport in front of two live granite slices
    (build_live_transport): 4 decode streams and 1 prefill stream, each
    over a SimLink with its own seeded chaos plan; session 1's home slice
    failed mid-stream; then one decode stream over UDP on loopback."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.core import Category
    from repro_torch.ingest import CameraSource, LinkPlan, SimLink, TransportSource
    from repro_torch.kernels import ops

    cfg = get_config(MID)
    names = ("slice0", "slice1")
    cluster, slices, _, deadline, gateway, transport, binding = granite_cluster(
        torch, names, transport=True, record_payloads=True, udp=True)
    if cluster.rehome_owner is not transport or binding.addr[0] != "127.0.0.1":
        raise AssertionError("transport: server not the rehome owner, or not on loopback")
    loop = cluster.loop
    period, frames = deadline / 2, 12
    deliveries = []
    deliver = transport._deliver

    def spy(ts, seq, payload, _deliver=deliver):
        deliveries.append((loop.now, ts.sid, seq))
        return _deliver(ts, seq, payload)

    transport._deliver = spy
    clients, sources, links = [], [], []
    for i in range(5):
        decode = i < 4
        link = SimLink(loop, transport.datagram,
                       plan=LinkPlan.from_seed(LINK_SEED + i, frames * 4, **CHAOS))
        src = CameraSource(period=period, n_frames=frames,
                           payload_shape=() if decode else (PREFILL_SEQ,),
                           vocab=cfg.vocab_size, seed=500 + i)
        shape = (DECODE_SEQ[MID],) if decode else (PREFILL_SEQ,)
        client = TransportSource(src, Category(MID, shape), deadline, link)
        if not client.start(transport):
            raise AssertionError(f"transport: stream {i} refused")
        clients.append(client)
        sources.append(src)
        links.append(link)
    victim = transport.sessions[1]
    home = victim.session.slice_name
    fail_at = loop.now + 4.2 * period
    state = {}

    def fail():
        state["t"] = loop.now
        state["victims"] = [rid for rid, n in cluster.placement.items() if n == home]
        state["parked"] = cluster.fail_slice(home)
        state["dead_stats"] = dict(slices[home].engine.stats)

    loop.schedule(fail_at, fail, priority=0)
    ops.reset_launch_counts()
    cluster.run(until=loop.now + frames * period + 4 * deadline)
    transport.finalize_all()
    cluster.run(until=loop.now + deadline)
    torch.cuda.synchronize()
    used = check_launches(ops, "transport")
    dead_engine = slices[home].engine
    if dict(dead_engine.stats) != state["dead_stats"]:
        raise AssertionError("transport: the failed slice's engine moved after the failure")
    for i, (client, src) in enumerate(zip(clients, sources)):
        ts = transport.sessions[i + 1]
        if ts.delivered_log != sorted(set(ts.delivered_log)):
            raise AssertionError(f"transport: session {i + 1} delivered out of order")
        for seq, payload in ts.delivered_payloads.items():
            if not np.array_equal(payload, src.payload(seq)):
                raise AssertionError(f"transport: session {i + 1} frame {seq} differs")
        if not ts.wire_conserved():
            raise AssertionError(f"transport: session {i + 1} wire not conserved: "
                                 f"{transport.status()['sessions'][str(i + 1)]['wire']}")
    if victim.rehomes < 1 or victim.session.slice_name == home:
        raise AssertionError("transport: the displaced session never re-homed")
    # The spy sees every frame handed to the gateway; only those it
    # delivered (not shed, nor lost to the dead slice) carry payloads.
    post = [(t, seq) for t, sid, seq in deliveries
            if sid == 1 and t >= state["t"] and seq in victim.delivered_payloads]
    if not post or not any(np.asarray(victim.delivered_payloads[seq]).any() for _, seq in post):
        raise AssertionError("transport: no real bytes delivered after the failover")
    agg = check_conserved(cluster, "transport")
    ledgers = check_accounted(cluster, state["victims"], "transport")
    check_survivors(slices, home, "transport")
    check_dead_engine(dead_engine, "transport")
    counts = transport_counts(transport, clients)
    rehome_ms = (post[0][0] - state["t"]) * 1e3
    chaos = [(l.sends, l.dropped, l.duplicated, l.reordered, l.delayed) for l in links]
    summary = cluster_summary(cluster, slices)
    summary["sessions"] = {
        sid: dict(slice=ts.session.slice_name, delivered=ts.delivered, shed=ts.shed,
                  late=ts.late_rejected, lost=ts.net_lost + ts.lost_to_slice,
                  duplicates=ts.duplicates, rehomes=ts.rehomes,
                  last_shed=ts.session.last_shed_reason)
        for sid, ts in transport.sessions.items()}
    summary.update(failed=home, ledgers=ledgers, launches=used, wire=counts, link_faults=chaos,
                   rehome_to_first_delivery_ms=rehome_ms, parked_at_failure=len(state["parked"]),
                   retransmits_rehomed=clients[0].retransmits, victim_rehomes=victim.rehomes)
    log(f"transport: delivered {counts['delivered']}, dropped {counts['dropped']}, lost "
        f"{counts['lost']}, refused {counts['refused']}, credits {counts['credits']}; "
        f"fail_slice({home}) to the re-homed session's first delivery {rehome_ms:.3f} ms; "
        f"misses {agg['missed_frames']}, e2e p99 {agg['e2e_p99'] * 1e3:.3f} ms")

    ops.reset_launch_counts()
    ts, _ = udp_arm(cluster, transport, binding, deadline)
    torch.cuda.synchronize()
    check_conserved(cluster, "transport udp")
    check_survivors(slices, home, "transport udp")
    summary["udp"] = dict(addr=list(binding.addr), delivered=ts.delivered,
                          log=ts.delivered_log, slice=ts.session.slice_name,
                          launches=ops.launch_counts())
    summary["peak_mem_bytes"] = close_cluster(torch, cluster, slices)
    log("transport: " + json.dumps(summary, sort_keys=True))


def attention_at_mixtral_shapes(torch):
    """Both attention kernels at mixtral-8x7b's swa shapes (32 query heads
    over 8 kv heads, head dim 128, window 4096) against their plain
    versions: prefill at the served buckets, decode over the served
    2048-slot ring with -1 sentinels and a dead row."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    gen = torch.Generator(device="cuda").manual_seed(4321)
    h, kv, d, window = 32, 8, 128, 4096
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for b in (1, 8):
            q = torch.randn((b, PREFILL_SEQ, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, PREFILL_SEQ, kv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, PREFILL_SEQ, kv, d), generator=gen, device="cuda").to(dtype)
            got = fk.flash_attention(q, k, v, causal=True, window=window)
            want = fk.flash_attention_plain(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            err = assert_close(f"flash mixtral B={b} {dtype_name}", got, want, TOL[dtype_name])
            log(f"flash {dtype_name} B={b} S={PREFILL_SEQ} H={h} KV={kv} D={d} causal "
                f"window={window}: max_abs_err={err:.3e}")
        q, ck, cv, cur, pos, valid, act = decode_inputs(
            torch, 8, 2048, h, kv, d, dtype, gen, ring=True,
            cursors=[2047, 3000, 2100, 4095, 2500, 5000, 2048, 9000],
            active=[1, 1, 1, 1, 0, 1, 1, 1])
        got = dk.decode_attention(q, ck, cv, cur, pos, valid, act, window=window)
        want = dk.decode_attention_plain(q, ck, cv, cur, pos, valid, act, window=window)
        torch.cuda.synchronize()
        err = assert_close(f"decode mixtral ring {dtype_name}", got, want, TOL[dtype_name])
        if bool(got[~act].float().abs().max() != 0):
            raise AssertionError("decode mixtral ring: a dead row is not exact 0")
        log(f"decode {dtype_name} B=8 S=2048 H={h} KV={kv} D={d} [ring, -1 sentinels, window "
            f"{window}, a dead row]: max_abs_err={err:.3e}")


def moe_drops(torch, engine, mid, seq):
    """Token-expert pairs dropped past capacity, summed over the MoE
    layers, in one decode step of every arena row (prefix mode, on the
    arena the served streams left) and in one batch-8 prefill, of zero
    frames as profiled and of seeded random tokens; run eagerly, outside
    the step graph."""
    from repro_torch.models import moe

    real = moe.dispatch_plan
    counted = []

    def spy(*args, **kw):
        plan = real(*args, **kw)
        counted.append((int((~plan.keep).sum()), int(plan.keep.numel()), plan.capacity))
        return plan

    gen = torch.Generator(device="cuda").manual_seed(9)
    vocab = engine.configs[mid].vocab_size
    model, params = engine.models[mid], engine.params[mid]
    out = {}
    moe.dispatch_plan = spy
    try:
        cur, active = engine._prefix_mode_inputs(mid, seq, engine.max_slots, "moe_drops")
        engine._decode_body(mid, seq)(torch.zeros_like(cur), cur, active)
        out["decode_step"] = counted[:]
        for label, toks in (
                ("prefill_b8_zero", torch.zeros((8, PREFILL_SEQ), dtype=torch.long,
                                                device="cuda")),
                ("prefill_b8_random", torch.randint(0, vocab, (8, PREFILL_SEQ), generator=gen,
                                                    device="cuda"))):
            counted.clear()
            with torch.no_grad():
                model.forward(params, toks)
            out[label] = counted[:]
    finally:
        moe.dispatch_plan = real
    return {k: dict(dropped=sum(c[0] for c in v), pairs=sum(c[1] for c in v),
                    capacity=v[0][2], layers=len(v)) for k, v in out.items()}


def phase_serve_moe(torch):
    """mixtral-8x7b at full width, MOE_LAYERS deep: numerics (2 layers,
    float32, kernel path against the dense path and the dense MoE oracle,
    decode against forward), the attention kernels at its head shapes,
    the decode step's graph (replay against eager, an 8-step chunk
    against 8 replays, bit for bit), then served by DeepRT."""
    log(f"mixtral-8x7b depth cut: {MOE_LAYERS} of 32 layers (full width); device memory "
        f"allocated before the phase: {torch.cuda.memory_allocated()} bytes")
    phase_model(torch, MIXTRAL, 2, moe_capacity_factor=4.0)
    attention_at_mixtral_shapes(torch)
    phase_graphs(torch, MIXTRAL, DECODE_SEQ[MID], n_layers=MOE_LAYERS)
    seq = DECODE_SEQ[MID]
    served = phase_serve(
        torch, {MIXTRAL: seq}, {"decode": 4, "prefill": 1}, frames=8, deadline_factor=6.0,
        overrides={MIXTRAL: dict(n_layers=MOE_LAYERS)},
        inspect=lambda engine: dict(
            weights_bytes=sum(t.numel() * t.element_size()
                              for t in _leaves(engine.params[MIXTRAL])),
            arena_bytes=engine.arena_nbytes(MIXTRAL, seq),
            drops=moe_drops(torch, engine, MIXTRAL, seq)))
    log(f"serve_moe: weights {served['weights_bytes'] / 1e9:.3f} GB, arena "
        f"{served['arena_bytes'] / 1e9:.3f} GB, peak {served['peak_mem_bytes'] / 1e9:.3f} GB; "
        f"WCETs {json.dumps(served['wcet'][MIXTRAL])}; dropped token-expert pairs "
        f"{json.dumps(served['drops'])}")
    log("served moe: " + json.dumps(served, sort_keys=True))


# ---------------------------------------------------------------------------
# phase serve_zoo: the rest of the engine-served zoo at full width
# ---------------------------------------------------------------------------


def attention_at_shapes(torch, report, name, h, kv, d, windows, *, seq=PREFILL_SEQ,
                        decode=True, previous=False):
    """Both attention kernels at one model's served shapes against their
    plain versions in bf16 and float32: flash causal at the prefill
    buckets B = 1 and 8 x ``seq``, once per entry of ``windows`` (None: a
    global layer); with ``decode``, decode over the 8-row arena with
    spread cursors and a dead row, at ZOO_DECODE_SEQ for a global layer
    and over a ring of the window's slots with -1 sentinels for a
    windowed one. The bf16 batch-8 shapes are timed beside SDPA and their
    bound (``previous``: in turns with each kernel's previous design);
    the records join the kernel rows' ``shapes``."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    gen = torch.Generator(device="cuda").manual_seed(h * 1000 + d + seq)
    act = [1, 1, 1, 1, 0, 1, 1, 1]
    tag = f"{name} H={h} KV={kv} (G {h // kv}) D={d}"

    def decode_case(dtype, window, cursors=None):
        ring = window is not None
        s = window if ring else ZOO_DECODE_SEQ
        if cursors is None:
            cursors = ([c * s // 1024 for c in (4095, 3000, 1100, 2047, 5000, 1500, 1024, 9000)]
                       if ring else [2047, 1500, 700, 2000, 100, 1900, 1024, 3])
        return s, decode_inputs(torch, 8, s, h, kv, d, dtype, gen, cursors=cursors,
                                active=act, ring=ring)

    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for w in windows:
            for b in (1, 8):
                q = torch.randn((b, seq, h, d), generator=gen, device="cuda").to(dtype)
                k = torch.randn((b, seq, kv, d), generator=gen, device="cuda").to(dtype)
                v = torch.randn((b, seq, kv, d), generator=gen, device="cuda").to(dtype)
                got = fk.flash_attention(q, k, v, causal=True, window=w)
                want = fk.flash_attention_plain(q, k, v, causal=True, window=w)
                torch.cuda.synchronize()
                err = assert_close(f"flash {tag} B={b} S={seq} window={w} {dtype_name}", got,
                                   want, TOL[dtype_name])
                log(f"flash {dtype_name} {tag} B={b} S={seq} causal window={w}: "
                    f"max_abs_err={err:.3e}")
            if not decode:
                continue
            s, (q, ck, cv, cur, pos, valid, a) = decode_case(dtype, w)
            got = dk.decode_attention(q, ck, cv, cur, pos, valid, a, window=w)
            want = dk.decode_attention_plain(q, ck, cv, cur, pos, valid, a, window=w)
            torch.cuda.synchronize()
            err = assert_close(f"decode {tag} S={s} window={w} {dtype_name}", got, want,
                               TOL[dtype_name])
            if bool(got[~a].float().abs().max() != 0):
                raise AssertionError(f"decode {tag}: a dead row is not exact 0")
            log(f"decode {dtype_name} {tag} B=8 S={s} "
                f"[{'ring, -1 sentinels, ' if w else ''}window {w}, a dead row]: "
                f"max_abs_err={err:.3e}")

    dtype, esz, b = torch.bfloat16, 2, 8
    flash_rows = report.setdefault("flash_attention", {}).setdefault("shapes", [])
    decode_rows = report.setdefault("decode_attention", {}).setdefault("shapes", [])
    for w in windows:
        # Every window here spans S: flash_case's causal check is the window's.
        inp, err = flash_case(torch, gen, dtype, b, seq, seq, h, kv, d, True)
        q, k, v = inp
        inputs = copies(inp, (q.numel() + 2 * k.numel()) * esz)
        lib_inputs = [tuple(x.transpose(1, 2).contiguous() for x in i) for i in inputs]
        pairs = sum(min(i + 1, w or seq) for i in range(seq))
        flash_rows.append(time_case(
            f"flash {tag} B={b} S={seq} causal window={w} bf16",
            lambda q_, k_, v_, w_=w: fk.flash_attention(q_, k_, v_, causal=True, window=w_),
            lambda q_, k_, v_, w_=w: fk.flash_attention_plain(q_, k_, v_, causal=True,
                                                              window=w_),
            lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_, is_causal=True,
                                                              enable_gqa=True),
            inputs, lib_inputs, (2 * q.numel() + 2 * k.numel()) * esz,
            4 * b * h * d * pairs, err,
            run_o=(lambda q_, k_, v_, w_=w: fk.previous_design(q_, k_, v_, causal=True,
                                                               window=w_))
            if previous else None))
        if not decode:
            continue
        s, base = decode_case(dtype, w, cursors=[(w or ZOO_DECODE_SEQ) * 2 - 1] * b)
        qd, ck, cv, cur, pos, valid, a = base
        inputs = copies(base, 2 * ck.numel() * esz)
        run_k = lambda *x, w_=w: dk.decode_attention(*x, window=w_)
        run_p = lambda *x, w_=w: dk.decode_attention_plain(*x, window=w_)
        err = assert_close(f"decode {tag} timed window={w}", run_k(*base), run_p(*base),
                           TOL["bfloat16"])
        lib_inputs = []
        for (q_, k_, v_, c_, p_, va_, a_) in inputs:
            mask = (p_ <= c_[:, None]) & va_ & a_[:, None]
            if w is not None:
                mask &= p_ > c_[:, None] - w
            lib_inputs.append((q_.transpose(1, 2).contiguous(), k_.transpose(1, 2).contiguous(),
                               v_.transpose(1, 2).contiguous(), mask[:, None, None, :]))
        n_live = live_slots(cur, pos, valid, a, w)
        decode_rows.append(time_case(
            f"decode {tag} B={b} S={s} window={w} bf16 (split plan "
            f"{dk.plan_splits(b, kv, s, dk._sm_count(qd.device))})", run_k, run_p,
            lambda q_, k_, v_, m_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_,
                                                                  enable_gqa=True),
            inputs, lib_inputs,
            qd.numel() * esz * 2 + 2 * n_live * kv * d * esz + b * 4 + b * s * 5,
            4 * n_live * h * d, err,
            run_o=(lambda *x, w_=w: dk.previous_design(*x, window=w_)) if previous else None))


def zoo_inspect(torch, engine, mid, seq):
    """After a zoo arch is served: the step graph's launches against
    CALLS_PER_STEP, one replay against the eager step (bit for bit) on
    rows leased at spread cursors (past gemma3's 1024-slot ring, so it
    wraps), and the weights' and arena's bytes; a MoE arch's token-expert
    pairs dropped past capacity."""
    graph = engine._graphs[("decode", mid, seq)]
    if graph.launches != CALLS_PER_STEP[mid]:
        raise AssertionError(f"{mid}: launches per step replay {graph.launches}, expected "
                             f"{CALLS_PER_STEP[mid]}")
    rows = engine.alloc_slots(mid, seq, 3, start_pos=seq // 20)
    rows += engine.alloc_slots(mid, seq, 3, start_pos=seq - seq // 7)
    gen = torch.Generator().manual_seed(11)
    vocab = engine.configs[mid].vocab_size
    payload = {r: int(torch.randint(0, vocab, (1,), generator=gen)) for r in rows}
    replay_vs_eager(torch, engine, mid, seq, payload)
    engine.free_slots(mid, seq, rows)
    check_no_captures(engine, mid)
    out = dict(
        launches_per_step=dict(graph.launches),
        weights_bytes=sum(t.numel() * t.element_size() for t in _leaves(engine.params[mid])),
        arena_bytes=engine.arena_nbytes(mid, seq))
    if engine.configs[mid].is_moe:
        out["drops"] = moe_drops(torch, engine, mid, seq)
    return out


def phase_serve_zoo(torch, report):
    """gemma3-12b, phi4-mini-3.8b, llama3-405b and llama4-maverick at full
    width, bf16, seed 0, ZOO_LAYERS deep, one arch at a time (each engine,
    its graphs and the allocator's cache freed before the next): both
    attention kernels at the arch's shapes, then served by DeepRT through
    the engine (1 prefill stream at seq 512 and 2 decode streams, 8
    frames, deadline 6 x (decode + batch-8 prefill WCET)): conservation,
    no miss, zero decode captures after warm-up, replay = eager bit for
    bit, launches per step; logs WCETs, weights, arena and peak memory."""
    from repro_torch.configs.registry import get_config

    for mid, n_layers in ZOO_LAYERS.items():
        full = get_config(mid).n_layers
        log(f"serve_zoo {mid}: {n_layers} of {full} layers (full width); device memory "
            f"allocated before it: {torch.cuda.memory_allocated()} bytes")
        cfg = get_config(mid)
        attention_at_shapes(
            torch, report, mid, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            [None] + ([cfg.sliding_window] if "swa" in cfg.block_pattern else []))
        seq = ZOO_DECODE_SEQ
        served = phase_serve(
            torch, {mid: seq}, {"decode": 2, "prefill": 1}, frames=8, deadline_factor=6.0,
            overrides={mid: dict(n_layers=n_layers)},
            inspect=lambda engine, mid=mid: zoo_inspect(torch, engine, mid, seq))
        log(f"serve_zoo {mid}: weights {served['weights_bytes'] / 1e9:.3f} GB, arena "
            f"{served['arena_bytes'] / 1e9:.3f} GB, peak {served['peak_mem_bytes'] / 1e9:.3f} "
            f"GB; WCETs {json.dumps(served['wcet'][mid])}; launches per step "
            f"{json.dumps(served['launches_per_step'])}"
            + (f"; dropped token-expert pairs {json.dumps(served['drops'])}"
               if "drops" in served else ""))
        log(f"served zoo {mid}: " + json.dumps(served, sort_keys=True))
        del served
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase multitenant_driver: the port's end-to-end driver at full width
# ---------------------------------------------------------------------------
# Streams and frames of each driver run (its CLI's defaults are 8 and 15):
# cut so that the four runs stay near a minute on the card.
DRIVER_REQUESTS = 4
DRIVER_FRAMES = 6
DRIVER_SEQ = 48  # the driver's prefill categories (its CLI's default)


def driver_kernels(torch, report, configs, seq):
    """The driver's two prefill kernels at the shapes its runs give them,
    against their plain versions in bf16 and float32: flash causal at
    granite's heads and wkv6 (f32 decays, no initial state as a prefill
    has, and with one) at rwkv6's, B = 1 and 8 x ``seq`` (below wkv6's
    CHUNK, so its sequential design); flash at bf16 batch 8 timed into
    its row's ``shapes``."""
    from repro_torch.kernels import wkv6 as wk

    g = configs[MID]
    attention_at_shapes(torch, report, MID, g.n_heads, g.n_kv_heads, g.resolved_head_dim,
                        [None], seq=seq, decode=False)
    r6 = configs[RWKV]
    h = r6.n_heads
    k = r6.d_model // h
    gen = torch.Generator(device="cuda").manual_seed(seq)
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for b in (1, 8):
            for with_state in (False, True):
                r, kk, v, w, u, state = wkv6_inputs(torch, gen, b, seq, h, k, dtype,
                                                    torch.float32, with_state)
                got, last = wk.wkv6(r, kk, v, w, u, state)
                want, want_last = wk.wkv6_plain(r, kk, v, w, u, state)
                torch.cuda.synchronize()
                design = "chunked" if wk.uses_chunked(dtype, seq) else "sequential"
                label = (f"wkv6 {RWKV} B={b} S={seq} H={h} K=V={k} r/k/v {name} w float32 "
                         f"state={with_state} [{design}]")
                err = max(assert_close(label, got, want, TOL[name]),
                          assert_close(label + " (last state)", last, want_last, TOL[name]))
                log(f"{label}: max_abs_err={err:.3e}")


@contextlib.contextmanager
def engines_built():
    """The ``InferenceEngine``s built inside the block, in a list (held
    until the block ends)."""
    from repro_torch.serving.engine import InferenceEngine

    made, init = [], InferenceEngine.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    InferenceEngine.__init__ = spy
    try:
        yield made
    finally:
        InferenceEngine.__init__ = init
        made.clear()


def phase_multitenant_driver(torch, report):
    """``repro_torch.launch.serve_multitenant.serve`` over full-width
    granite-3-2b and rwkv6-1.6b (bf16, the driver's prefill categories at
    seq 48) in the reference driver's four topologies: one device (its
    DeepRT and BATCH-4 lines), 2 slices, 2 slices behind the gateway with
    camera sources, 2 slices behind the transport with a Chrome trace.
    Before the runs, both prefill kernels against their plain versions at
    the runs' shapes (``driver_kernels``). Each run: conservation, zero
    decode and prefill captures on every slice, both prefill kernels
    launched (counts set to 0 just before the run and read after it),
    each live engine's prefill replays against the eager body
    (``prefill_graph_checks``); the trace run writes spans. Logs the host
    stall a job and the run's peak memory."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_multitenant import serve

    configs = {MID: get_config(MID), RWKV: get_config(RWKV)}
    driver_kernels(torch, report, configs, DRIVER_SEQ)
    runs = (("single", {}), ("slices 2", dict(slices=2)),
            ("slices 2 camera", dict(slices=2, source="camera")),
            ("slices 2 transport", dict(slices=2, transport=True)))
    with tempfile.TemporaryDirectory() as tmp:
        for label, kw in runs:
            gc.collect()
            torch.cuda.empty_cache()
            if kw.get("transport"):
                kw["trace"] = os.path.join(tmp, "trace.json")
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with engines_built() as engines:
                rec = serve(configs, requests=DRIVER_REQUESTS, seq=DRIVER_SEQ,
                            frames=DRIVER_FRAMES, device="cuda", **kw)
                torch.cuda.synchronize()
                launches = ops.launch_counts()
                log(f"driver {label}: {time.perf_counter() - t0:.3f} s; launches {launches}; "
                    + json.dumps(rec, sort_keys=True, default=str))
                # Each live slice's engine (a failed slice's is frozen):
                # its prefill replays against the eager body.
                for engine in engines:
                    if not engine.frozen:
                        for mid in configs:
                            prefill_graph_checks(torch, engine, mid, DRIVER_SEQ)
            log(f"driver {label}: host stall a job " + ", ".join(
                f"{n} {sl['host_stall_us']:.1f} us" for n, sl in rec["slices"].items())
                + f"; peak memory {torch.cuda.max_memory_allocated()} bytes allocated, "
                f"{torch.cuda.max_memory_reserved()} reserved")
            if not rec["conserved"]:
                raise AssertionError(f"driver {label}: conservation failed: {rec['metrics']}")
            if any(s["decode_compiles"] or s["prefill_compiles"] for s in rec["slices"].values()):
                raise AssertionError(f"driver {label}: captures after warm-up {rec['slices']}")
            if rec["metrics"]["completed_frames"] < 1:
                raise AssertionError(f"driver {label}: no frame completed")
            for name in ("flash_attention", "wkv6"):
                if launches[name] < 1:
                    raise AssertionError(f"driver {label}: kernel {name} was not launched")
            if label == "single" and "batch4" not in rec:
                raise AssertionError("driver single: no BATCH-4 line")
            if kw.get("trace"):
                with open(kw["trace"]) as f:
                    events = len(json.load(f)["traceEvents"])
                if not rec.get("spans", 0) > 0 or events < 1:
                    raise AssertionError(f"driver {label}: trace spans {rec.get('spans')}, "
                                         f"{events} events written")


# ---------------------------------------------------------------------------
# phase examples: the two virtual-clock launchers
# ---------------------------------------------------------------------------


def phase_examples():
    """``launch.quickstart`` and ``launch.cluster_sim``, each run as its
    ``main()`` with its printed lines captured and logged."""
    import io

    from repro_torch.launch import cluster_sim, quickstart

    for name, main in (("quickstart", quickstart.main), ("cluster_sim", cluster_sim.main)):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = main()
        secs = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            if line:
                log(f"{name}: {line}")
        log(f"{name}: {secs:.3f} s of host time (virtual clock)")
        if name == "quickstart" and result.missed_frames:
            raise AssertionError(f"quickstart: {result.missed_frames} admitted frames missed")
        if name == "cluster_sim" and not out.getvalue().startswith("placed 39/40 "):
            raise AssertionError(f"cluster_sim placed: {out.getvalue().splitlines()[0]}")


# ---------------------------------------------------------------------------
# phases 17-18: whisper-large-v3 (encoder-decoder) and qwen2-vl-72b (M-RoPE)
# ---------------------------------------------------------------------------


def qwen_vl_positions(torch, b, s, prefixes, device="cuda"):
    """Qwen2-VL's M-RoPE position ids (3, B, S) int32 for rows of text, one
    image, text (Qwen2-VL's `get_rope_index`): row r's ``prefixes[r]`` text
    tokens sit at t = h = w = 0 .. p-1; its gh x gw image tokens all at
    temporal position p, at heights p + i and widths p + j; the text after
    it from p + max(gh, gw) on all three streams. The temporal stream is
    non-decreasing, and an image's tokens share one temporal position."""
    gh, gw = IMAGE_GRID
    n_img = gh * gw
    pos = torch.empty((3, b, s), dtype=torch.int32)
    for r, p in enumerate(prefixes):
        pos[:, r, :p] = torch.arange(p)
        img = slice(p, p + n_img)
        pos[0, r, img] = p
        pos[1, r, img] = p + torch.arange(gh).repeat_interleave(gw)
        pos[2, r, img] = p + torch.arange(gw).repeat(gh)
        pos[:, r, p + n_img:] = p + max(gh, gw) + torch.arange(s - p - n_img)
    return pos.to(device)


def text_positions(torch, b, s, device="cuda"):
    """Text-only M-RoPE positions: arange on all three streams."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(3, b, s).contiguous()


def time_case(label, run_k, run_p, run_lib, inputs, lib_inputs, nbytes, flops, err,
              run_o=None):
    """Device ms of the kernel and of the library call (CUDA-graph replays
    over ``inputs``), the plain version's eager ms, and the bound; with
    ``run_o`` (a previous design) the kernel is timed in turns with it.
    Logged and returned as a record."""
    rec = {}
    if run_o is None:
        ms = device_ms(run_k, inputs)
    else:
        ms, rec["previous_ms"] = in_turns(run_k, run_o, inputs)
    plain_ms = time_ms(run_p, inputs, iters=3, warmup=1)
    library_ms = device_ms(run_lib, lib_inputs)
    bound_ms, bound_by = bound(nbytes, flops)
    previous = f", previous design {rec['previous_ms']:.4f} ms" if rec else ""
    log(f"{label}: kernel {ms:.4f} ms{previous}, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, "
        f"{flops} flops)")
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, **rec)


def copies(inp, per_copy):
    """``inp`` and enough clones of its tensors that a cycle exceeds L2."""
    return [inp] + [tuple(t.clone() if hasattr(t, "clone") else t for t in inp)
                    for _ in range(n_copies(per_copy) - 1)]


def flash_case(torch, gen, dtype, b, s, skv, h, kv, d, causal, pos=None):
    """One flash check against the plain version; returns (inputs, err)."""
    from repro_torch.kernels import flash_attention as fk

    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, skv, kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, skv, kv, d), generator=gen, device="cuda").to(dtype)
    kw = {} if pos is None else dict(q_pos=pos, kv_pos=pos)
    got = fk.flash_attention(q, k, v, causal=causal, **kw)
    want = fk.flash_attention_plain(q, k, v, causal=causal, **kw)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    err = assert_close(f"flash B={b} S={s} S_kv={skv} H={h} D={d} {name}", got, want,
                       TOL[name])
    return (q, k, v), err


def attention_at_whisper_shapes(torch, report):
    """Both attention kernels at whisper-large-v3's shapes (H = KV = 20,
    D = 64, one query head a kv head): flash non-causal over the encoder's
    1500 frames, causal over the decoder's tokens and cross at S_kv = 1500
    (and a ragged case); decode over the 448-slot self cache and, with
    causal=False, over the 1500-frame cross cache, a dead row in each.
    Times the four served shapes with SDPA beside them."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    gen = torch.Generator(device="cuda").manual_seed(1500)
    h = kv = 20
    d, t = 64, WHISPER_FRAMES
    flash_cases = [("encoder", 8, t, t, False), ("decoder self", 8, WHISPER_STEPS,
                                                  WHISPER_STEPS, True),
                   ("cross", 8, WHISPER_STEPS, t, False), ("cross ragged", 2, 100, 1437, False)]
    act = [1, 1, 1, 1, 1, 1, 1, 0]
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for label, b, s, skv, causal in flash_cases:
            _, err = flash_case(torch, gen, dtype, b, s, skv, h, kv, d, causal)
            log(f"flash whisper {label} {dtype_name} B={b} S={s} S_kv={skv} H={h} KV={kv} "
                f"D={d} causal={causal}: max_abs_err={err:.3e}")
        q, ck, cv, cur, pos, valid, a = decode_inputs(
            torch, 8, WHISPER_DEC_SLOTS, h, kv, d, dtype, gen, active=act,
            cursors=[447, 300, 31, 5, 0, 200, 100, 50])
        got = dk.decode_attention(q, ck, cv, cur, pos, valid, a)
        want = dk.decode_attention_plain(q, ck, cv, cur, pos, valid, a)
        torch.cuda.synchronize()
        err = assert_close(f"decode whisper self {dtype_name}", got, want, TOL[dtype_name])
        log(f"decode whisper self {dtype_name} B=8 S={WHISPER_DEC_SLOTS} H={h} KV={kv} D={d} "
            f"[cursors spread, a dead row]: max_abs_err={err:.3e}")
        # Cross: every encoder frame live whatever the cursor (causal=False).
        q, ck, cv, cur, _, _, a = decode_inputs(
            torch, 8, t, h, kv, d, dtype, gen, active=act, cursors=[0, 5, 31, 200, 447, 3, 1, 9])
        pos = torch.arange(t, dtype=torch.int32, device="cuda").expand(8, t).contiguous()
        valid = a[:, None].expand(8, t).contiguous()
        got = dk.decode_attention(q, ck, cv, cur, pos, valid, a, causal=False)
        want = dk.decode_attention_plain(q, ck, cv, cur, pos, valid, a, causal=False)
        causal_out = dk.decode_attention(q, ck, cv, cur, pos, valid, a)
        torch.cuda.synchronize()
        err = assert_close(f"decode whisper cross {dtype_name}", got, want, TOL[dtype_name])
        if bool(got[~a].float().abs().max() != 0):
            raise AssertionError("decode whisper cross: a dead row is not exact 0")
        gap = (got[a].float() - causal_out[a].float()).abs().max().item()
        if not gap > 0.1:
            raise AssertionError("decode whisper cross: causal=False reads like causal=True")
        log(f"decode whisper cross {dtype_name} B=8 S={t} H={h} KV={kv} D={d} causal=False "
            f"[cursors below S, a dead row]: max_abs_err={err:.3e} (causal=True differs by "
            f"{gap:.3e})")

    dtype = torch.bfloat16
    esz = 2
    records = report.setdefault("flash_attention", {}).setdefault("shapes", [])
    for label, b, s, skv, causal in flash_cases[:3]:
        inp, err = flash_case(torch, gen, dtype, b, s, skv, h, kv, d, causal)
        q, k, v = inp
        inputs = copies(inp, (q.numel() + 2 * k.numel()) * esz)
        lib_inputs = [tuple(x.transpose(1, 2).contiguous() for x in i) for i in inputs]
        pairs = s * (s + 1) // 2 if causal else s * skv
        records.append(time_case(
            f"flash whisper {label} B={b} S={s} S_kv={skv} H={h} D={d} bf16",
            lambda q_, k_, v_, c=causal: fk.flash_attention(q_, k_, v_, causal=c),
            lambda q_, k_, v_, c=causal: fk.flash_attention_plain(q_, k_, v_, causal=c),
            lambda q_, k_, v_, c=causal: F.scaled_dot_product_attention(q_, k_, v_, is_causal=c),
            inputs, lib_inputs, (2 * q.numel() + 2 * k.numel()) * esz, 4 * b * h * d * pairs,
            err))
    records = report.setdefault("decode_attention", {}).setdefault("shapes", [])
    for label, s, causal in (("self", WHISPER_DEC_SLOTS, True), ("cross", t, False)):
        base = decode_inputs(torch, 8, s, h, kv, d, dtype, gen, cursors=[s - 1] * 8)
        q, ck, cv, cur, pos, valid, a = base
        inputs = copies(base, 2 * ck.numel() * esz)
        run_k = lambda *x, c=causal: dk.decode_attention(*x, causal=c)
        run_p = lambda *x, c=causal: dk.decode_attention_plain(*x, causal=c)
        err = assert_close(f"decode whisper {label} timed", run_k(*base), run_p(*base),
                           TOL["bfloat16"])
        lib_inputs = [(i[0].transpose(1, 2).contiguous(), i[1].transpose(1, 2).contiguous(),
                       i[2].transpose(1, 2).contiguous(), i[5][:, None, None, :])
                      for i in inputs]
        n_live = 8 * s  # every slot live
        records.append(time_case(
            f"decode whisper {label} B=8 S={s} H={h} KV={kv} D={d} bf16 causal={causal}",
            run_k, run_p,
            lambda q_, k_, v_, m_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_),
            inputs, lib_inputs,
            q.numel() * esz * 2 + 2 * n_live * kv * d * esz + 8 * 4 + 8 * s * 5,
            4 * n_live * kv * d, err))


def attention_at_qwen_vl_shapes(torch, report):
    """Both attention kernels at qwen2-vl-72b's shapes (H = 64, KV = 8,
    D = 128): flash causal over Qwen2-VL position ids (an image's 256
    tokens share one temporal position, so they attend to each other both
    ways), at B = 8 x 512 with the image at a different offset per row, a
    ragged S and B = 1; decode over the 2048-slot cache. Times the
    position-valued flash (SDPA given the same mask explicitly) and decode."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    gen = torch.Generator(device="cuda").manual_seed(72)
    h, kv, d = 64, 8, 128
    prefixes = [0, 17, 64, 100, 128, 200, 240, 253]
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for b, s in ((8, PREFILL_SEQ), (8, 509), (1, PREFILL_SEQ)):
            pos = qwen_vl_positions(torch, b, s, prefixes[-b:])[0].contiguous()
            (q, k, v), err = flash_case(torch, gen, dtype, b, s, s, h, kv, d, True, pos)
            arange = fk.flash_attention(q, k, v, causal=True)
            gap = (arange.float() - fk.flash_attention(q, k, v, causal=True, q_pos=pos,
                                                       kv_pos=pos).float()).abs().max().item()
            if not gap > 0.1:
                raise AssertionError("flash: position-valued mask reads like arange")
            log(f"flash qwen2-vl {dtype_name} B={b} S={s} H={h} KV={kv} D={d} causal, "
                f"M-RoPE temporal positions: max_abs_err={err:.3e} (arange mask differs by "
                f"{gap:.3e})")
        q, ck, cv, cur, pos, valid, a = decode_inputs(
            torch, 8, QWEN_DECODE_SEQ, h, kv, d, dtype, gen, active=[1, 1, 0, 1, 1, 1, 1, 1],
            cursors=[2047, 1500, 700, 530, 512, 600, 1024, 2000])
        got = dk.decode_attention(q, ck, cv, cur, pos, valid, a)
        want = dk.decode_attention_plain(q, ck, cv, cur, pos, valid, a)
        torch.cuda.synchronize()
        err = assert_close(f"decode qwen2-vl {dtype_name}", got, want, TOL[dtype_name])
        log(f"decode qwen2-vl {dtype_name} B=8 S={QWEN_DECODE_SEQ} H={h} KV={kv} D={d} "
            f"[cursors spread, a dead row]: max_abs_err={err:.3e}")

    dtype, esz, b, s = torch.bfloat16, 2, 8, PREFILL_SEQ
    pos = qwen_vl_positions(torch, b, s, prefixes)[0].contiguous()
    (q, k, v), err = flash_case(torch, gen, dtype, b, s, s, h, kv, d, True, pos)
    inputs = copies((q, k, v, pos), (q.numel() + 2 * k.numel()) * esz)
    mask = pos[:, None, :] <= pos[:, :, None]  # (B, S query, S key)
    lib_inputs = [(i[0].transpose(1, 2).contiguous(), i[1].transpose(1, 2).contiguous(),
                   i[2].transpose(1, 2).contiguous(), mask[:, None]) for i in inputs]
    pairs = int(mask.sum())
    rec = time_case(
        f"flash qwen2-vl B={b} S={s} H={h} KV={kv} D={d} bf16 causal, M-RoPE positions",
        lambda q_, k_, v_, p_: fk.flash_attention(q_, k_, v_, causal=True, q_pos=p_, kv_pos=p_),
        lambda q_, k_, v_, p_: fk.flash_attention_plain(q_, k_, v_, causal=True, q_pos=p_,
                                                        kv_pos=p_),
        lambda q_, k_, v_, m_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_,
                                                              enable_gqa=True),
        inputs, lib_inputs, (2 * q.numel() + 2 * k.numel()) * esz + 2 * pos.numel() * 4,
        4 * h * d * pairs, err)
    rec["arange_ms"] = device_ms(lambda q_, k_, v_, p_: fk.flash_attention(q_, k_, v_),
                                 inputs)
    log(f"flash qwen2-vl same inputs, arange mask: kernel {rec['arange_ms']:.4f} ms")
    report.setdefault("flash_attention", {}).setdefault("shapes", []).append(rec)
    base = decode_inputs(torch, 8, QWEN_DECODE_SEQ, h, kv, d, dtype, gen,
                         cursors=[QWEN_DECODE_SEQ - 1] * 8)
    q, ck, cv, cur, pos, valid, a = base
    inputs = copies(base, 2 * ck.numel() * esz)
    err = assert_close("decode qwen2-vl timed", dk.decode_attention(*base),
                       dk.decode_attention_plain(*base), TOL["bfloat16"])
    lib_inputs = [(i[0].transpose(1, 2).contiguous(), i[1].transpose(1, 2).contiguous(),
                   i[2].transpose(1, 2).contiguous(), i[5][:, None, None, :]) for i in inputs]
    n_live = 8 * QWEN_DECODE_SEQ
    report.setdefault("decode_attention", {}).setdefault("shapes", []).append(time_case(
        f"decode qwen2-vl B=8 S={QWEN_DECODE_SEQ} H={h} KV={kv} D={d} bf16",
        lambda *x: dk.decode_attention(*x), lambda *x: dk.decode_attention_plain(*x),
        lambda q_, k_, v_, m_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_,
                                                              enable_gqa=True),
        inputs, lib_inputs,
        q.numel() * esz * 2 + 2 * n_live * kv * d * esz + 8 * 4 + 8 * QWEN_DECODE_SEQ * 5,
        4 * n_live * kv * (h // kv) * d, err))


@contextlib.contextmanager
def launches_by_shape():
    """Count the two attention kernels' launches by shape while the block
    runs (their wrappers' own counters count them as well)."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    counts = collections.Counter()
    real = fk.flash_attention, dk.decode_attention

    def flash(q, k, v, **kw):
        counts[f"flash S={q.shape[1]} S_kv={k.shape[1]} causal={kw.get('causal', True)} "
               f"positions={kw.get('q_pos') is not None}"] += 1
        return real[0](q, k, v, **kw)

    def decode(q, cache_k, *args, **kw):
        counts[f"decode S={cache_k.shape[1]} causal={kw.get('causal', True)}"] += 1
        return real[1](q, cache_k, *args, **kw)

    fk.flash_attention, dk.decode_attention = flash, decode
    try:
        yield counts
    finally:
        fk.flash_attention, dk.decode_attention = real


def live_rows_close(name, got, want, live, tol):
    """assert_close on the live rows (dim 0) only; returns the max error."""
    return assert_close(name, got[live], want[live], tol)


def within_std(name, got, want, frac=None):
    """bf16 logits of two paths: max |got - want| <= ``frac`` (default
    BF16_LOGIT_TOL_STD) x the standard deviation of ``want``. Returns
    (max abs error, the tolerance it was held to)."""
    frac = BF16_LOGIT_TOL_STD if frac is None else frac
    want = want.float()
    tol = frac * want.std().item()
    err = (got.float() - want).abs().max().item()
    if not bool(got.float().isfinite().all()):
        raise AssertionError(f"{name}: non-finite logits")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err:.3e} beyond {tol:.3e} "
                             f"({frac} x the logits' std)")
    return err, tol


def encdec_numerics(torch):
    """whisper-large-v3 at full width, 2 + 2 layers, float32, seeded
    weights and 1500 frames: the kernel path against impl="dense"
    (forward, and encode_for_decode + decode with a dead row), and decode
    against the teacher-forced forward, at 2e-3 on live rows."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_for

    cfg = get_config(WHISPER, n_layers=2, n_encoder_layers=2, param_dtype="float32")
    m_k = model_for(cfg)
    m_d = model_for(dataclasses.replace(cfg, impl="dense"))
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = m_k.init(gen, device="cuda")
    b, t, s = 2, WHISPER_FRAMES, 33
    frames = 0.1 * torch.randn((b, t, cfg.d_model), generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    active = torch.tensor([True, False], device="cuda")
    with torch.no_grad():
        lk, _ = m_k.forward(params, frames, toks)
        ld, _ = m_d.forward(params, frames, toks)
        err = assert_close("whisper x2 forward logits", lk, ld, 2e-3)
        loss = float(m_k.loss(params, frames, toks))
        if not math.isfinite(loss):
            raise AssertionError("whisper x2 loss is not finite")
        outs = []
        for m in (m_k, m_d):
            cache = m.init_cache(b, 64, t, device="cuda")
            m.encode_for_decode(params, frames, cache)
            steps = []
            for i in range(s):
                cur = torch.full((b,), i, dtype=torch.int32, device="cuda")
                lg, _ = m.decode_step(params, cache, toks[:, i], cur, active=active)
                steps.append(lg)
            outs.append(torch.stack(steps, dim=1))
        err2 = live_rows_close("whisper x2 decode kernel vs dense", outs[0], outs[1],
                               active, 2e-3)
        err3 = live_rows_close("whisper x2 decode vs forward", outs[0], lk, active, 2e-3)
    log(f"model {WHISPER} 2+2 layers f32 B={b} T={t} S={s}: forward kernel vs dense "
        f"max_abs_err={err:.3e}, loss {loss:.4f}; decode (a dead row) kernel vs dense "
        f"{err2:.3e}, decode vs forward {err3:.3e}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def greedy_decode(torch, model, params, cache, first, steps, active, **kw):
    """``steps`` greedy decode steps from token ``first`` (B,) at cursors 0,
    1, ...; returns (input tokens (B, steps), logits (B, steps, V))."""
    b = first.shape[0]
    toks, logits = [first], []
    for i in range(steps):
        cur = torch.full((b,), i, dtype=torch.int32, device="cuda")
        lg, _ = model.decode_step(params, cache, toks[-1], cur, active=active, **kw)
        logits.append(lg)
        toks.append(lg.argmax(-1))
    return torch.stack(toks[:-1], dim=1), torch.stack(logits, dim=1)


def check_argmax(name, got, want, live, tol):
    """Each live row's argmax of ``got`` is an argmax of ``want`` within
    ``tol``, and the other way round: argmax equality up to near-ties that
    the stated tolerance cannot order. Returns (exactly equal, compared)."""
    g, w = got[live].float(), want[live].float()
    ig, iw = g.argmax(-1), w.argmax(-1)
    w_at_g = w.gather(-1, ig[..., None])[..., 0]
    g_at_w = g.gather(-1, iw[..., None])[..., 0]
    bad = (w_at_g < w.amax(-1) - tol) | (g_at_w < g.amax(-1) - tol)
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} argmax beyond the tolerance {tol}")
    return int((ig == iw).sum()), ig.numel()


def phase_encdec(torch, report):
    """whisper-large-v3 at full width and depth through the model API (the
    reference serves it there, not through DeepRT's engine): kernels at its
    shapes, 2+2-layer float32 numerics, then bf16 with 8 rows (one dead)
    and 1500 seeded frame embeddings: encode_for_decode, WHISPER_STEPS
    greedy decode steps into a 448-slot self cache, a teacher-forced
    forward over the same tokens (decode against it within
    BF16_LOGIT_TOL_STD of the logits' std, and its argmax, on live rows), then the parameters through the port's
    CheckpointManager (async save, restore onto the card, torch.equal per
    leaf)."""
    import shutil

    from repro_torch.checkpoint.checkpoint import CheckpointManager, leaf_paths
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_for

    attention_at_whisper_shapes(torch, report)
    encdec_numerics(torch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(WHISPER)
    model = model_for(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"{WHISPER}: {cfg.n_encoder_layers} + {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.max_dec_positions} decoder positions: {n_params} parameters, "
        f"{w_bytes} bytes ({cfg.param_dtype})")
    b, t = 8, WHISPER_FRAMES
    frames = (0.1 * torch.randn((b, t, cfg.d_model), generator=gen, device="cuda")).to(cfg.dtype)
    first = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device="cuda")
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    active[-1] = False
    ops.reset_launch_counts()
    with torch.no_grad(), launches_by_shape() as by_shape:
        cache = model.init_cache(b, WHISPER_DEC_SLOTS, t, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.encode_for_decode(params, frames, cache)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks, dec = greedy_decode(torch, model, params, cache, first, WHISPER_STEPS, active)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fwd, _ = model.forward(params, frames, toks)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    cross_bytes = sum(cache[n].numel() * cache[n].element_size() for n in ("cross_k", "cross_v"))
    if not torch.isfinite(fwd).all() or tuple(fwd.shape) != (b, WHISPER_STEPS, cfg.vocab_size):
        raise AssertionError(f"whisper forward: bad logits {tuple(fwd.shape)}")
    err, tol = within_std("whisper decode vs forward (bf16)", dec[active], fwd[active])
    same, n = check_argmax("whisper decode vs forward argmax", dec, fwd, active, tol)
    for name in ("flash_attention", "decode_attention"):
        if launches[name] < 1:
            raise AssertionError(f"encdec: {name} was never launched")
    log(f"encdec bf16 B={b} (1 dead) T={t}: encode_for_decode {enc_s * 1e3:.3f} ms (cross K/V "
        f"{cross_bytes} bytes), {WHISPER_STEPS} greedy decode steps {dec_s * 1e3:.3f} ms "
        f"({dec_s * 1e3 / WHISPER_STEPS:.3f} ms a step, eager), teacher-forced forward "
        f"{fwd_s * 1e3:.3f} ms; decode vs forward max_abs_err={err:.3e} (tol {tol:.3e}, "
        f"{BF16_LOGIT_TOL_STD} x the logits' std), argmax equal at {same} of {n} live "
        f"positions (the rest within the tolerance of the forward's top logit); peak {torch.cuda.max_memory_allocated()} bytes; "
        f"launches {json.dumps(launches)}, by shape {json.dumps(by_shape)}")
    report["encdec"] = dict(launches=launches, by_shape=dict(by_shape), n_params=n_params,
                            weights_bytes=w_bytes, argmax_equal=[same, n],
                            encode_ms=enc_s * 1e3, decode_step_ms=dec_s * 1e3 / WHISPER_STEPS,
                            forward_ms=fwd_s * 1e3, decode_vs_forward=err, tol=tol)
    del cache, dec, fwd

    ckdir = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = CheckpointManager(str(ckdir), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, params)
    stall_s = time.perf_counter() - t0
    mgr.wait()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = mgr.restore(1, params, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    disk = sum(f.stat().st_size for f in ckdir.rglob("*") if f.is_file())
    a, r = leaf_paths(params), leaf_paths(restored)
    if [n for n, _ in a] != [n for n, _ in r]:
        raise AssertionError("checkpoint: leaf names differ after restore")
    for (name, x), (_, y) in zip(a, r):
        if y.device != x.device or y.dtype != x.dtype or not torch.equal(x, y):
            raise AssertionError(f"checkpoint: leaf {name} differs after restore")
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"checkpoint {WHISPER}: {len(a)} leaves, {disk} bytes on disk; save stall "
        f"{stall_s * 1e3:.3f} ms, written after {write_s * 1e3:.3f} ms, restored onto the "
        f"card in {restore_s * 1e3:.3f} ms; every leaf torch.equal")
    report["encdec"].update(ckpt_stall_ms=stall_s * 1e3, ckpt_write_ms=write_s * 1e3,
                            ckpt_restore_ms=restore_s * 1e3, ckpt_bytes=disk)
    del params, restored
    gc.collect()
    torch.cuda.empty_cache()


def mrope_numerics(torch):
    """qwen2-vl-72b at full width, 2 layers, float32: the kernel path
    against impl="dense" on Qwen2-VL positions (forward; prefill + decode
    steps at the default mrope_position, the cursor on all three
    streams), and, on text-only positions, decode against the
    teacher-forced forward, at 2e-3."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_for

    cfg = get_config(QWEN_VL, n_layers=2, param_dtype="float32")
    m_k = model_for(cfg)
    m_d = model_for(dataclasses.replace(cfg, impl="dense"))
    gen = torch.Generator(device="cuda").manual_seed(13)
    params = m_k.init(gen, device="cuda")
    b, s, n_dec = 2, 300, 4
    toks = torch.randint(0, cfg.vocab_size, (b, s + n_dec), generator=gen, device="cuda")
    pos = qwen_vl_positions(torch, b, s, [20, 33])
    with torch.no_grad():
        lk, _ = m_k.forward(params, toks[:, :s], pos)
        ld, _ = m_d.forward(params, toks[:, :s], pos)
        err = assert_close("qwen2-vl x2 forward logits (vision positions)", lk, ld, 2e-3)
        outs = []
        for m in (m_k, m_d):
            cache = m.init_cache(b, s + n_dec, device="cuda")
            lg, _ = m.prefill(params, cache, toks[:, :s], pos)
            steps = [lg]
            for i in range(n_dec):
                cur = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
                lg, _ = m.decode_step(params, cache, toks[:, s + i], cur)
                steps.append(lg)
            outs.append(torch.stack(steps))
        err2 = assert_close("qwen2-vl x2 prefill+decode kernel vs dense", outs[0], outs[1], 2e-3)
        tpos = text_positions(torch, b, s + n_dec)
        full, _ = m_k.forward(params, toks, tpos)
        cache = m_k.init_cache(b, s + n_dec, device="cuda")
        m_k.prefill(params, cache, toks[:, :s], tpos[:, :, :s])
        steps = []
        for i in range(n_dec):
            cur = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            steps.append(m_k.decode_step(params, cache, toks[:, s + i], cur)[0])
        err3 = assert_close("qwen2-vl x2 decode vs forward (text)", torch.stack(steps, 1),
                            full[:, s:], 2e-3)
    log(f"model {QWEN_VL} x2 f32 B={b} S={s}: forward kernel vs dense (vision positions) "
        f"max_abs_err={err:.3e}; prefill+{n_dec} decode kernel vs dense {err2:.3e}; decode "
        f"vs forward (text positions) {err3:.3e}")
    del params, lk, ld, full
    gc.collect()
    torch.cuda.empty_cache()


def phase_mrope(torch, report):
    """qwen2-vl-72b at full width, MROPE_LAYERS of its 80 layers, through
    the model API (the reference's engine cannot prefill it): kernels at
    its shapes, 2-layer float32 numerics, then bf16: a batch-8 x 512
    forward on Qwen2-VL positions, kernel path against the dense path;
    prefill on them and 32 decode steps into a 2048-slot cache at the
    default mrope_position, kernel against dense (the reference's
    semantics); on text-only positions, prefill + 32 decode steps against
    the teacher-forced forward over the same tokens."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_for

    attention_at_qwen_vl_shapes(torch, report)
    mrope_numerics(torch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"{QWEN_VL} depth cut: {MROPE_LAYERS} of 80 layers (full width); device memory "
        f"allocated before: {torch.cuda.memory_allocated()} bytes")
    cfg = get_config(QWEN_VL, n_layers=MROPE_LAYERS)
    m_k = model_for(cfg)
    m_d = model_for(dataclasses.replace(cfg, impl="dense"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m_k.init(gen, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"{QWEN_VL} x{MROPE_LAYERS}: d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {n_params} parameters, {w_bytes} bytes ({cfg.param_dtype})")
    b, s, n_dec = 8, PREFILL_SEQ, MROPE_STEPS
    toks = torch.randint(0, cfg.vocab_size, (b, s + n_dec), generator=gen, device="cuda")
    pos = qwen_vl_positions(torch, b, s, [0, 17, 64, 100, 128, 200, 240, 253])
    ops.reset_launch_counts()
    times = {}
    with torch.no_grad(), launches_by_shape() as by_shape:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, _ = m_k.forward(params, toks[:, :s], pos)
        torch.cuda.synchronize()
        times["forward_ms"] = (time.perf_counter() - t0) * 1e3
        ld, _ = m_d.forward(params, toks[:, :s], pos)
        if not torch.isfinite(lk).all():
            raise AssertionError("qwen2-vl forward: non-finite logits")
        err, tol = within_std("qwen2-vl forward kernel vs dense (bf16)", lk, ld)
        del lk, ld
        outs = []
        for m in (m_k, m_d):
            cache = m.init_cache(b, QWEN_DECODE_SEQ, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = m.prefill(params, cache, toks[:, :s], pos)
            torch.cuda.synchronize()
            times.setdefault("prefill_ms", (time.perf_counter() - t0) * 1e3)
            steps = [lg]
            t0 = time.perf_counter()
            for i in range(n_dec):
                cur = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
                steps.append(m.decode_step(params, cache, toks[:, s + i], cur)[0])
            torch.cuda.synchronize()
            times.setdefault("decode_step_ms", (time.perf_counter() - t0) * 1e3 / n_dec)
            outs.append(torch.stack(steps))
            del cache
        err2, tol2 = within_std("qwen2-vl prefill+decode kernel vs dense (bf16)", outs[0],
                                outs[1])
        del outs
        tpos = text_positions(torch, b, s + n_dec)
        cache = m_k.init_cache(b, QWEN_DECODE_SEQ, device="cuda")
        m_k.prefill(params, cache, toks[:, :s], tpos[:, :, :s])
        steps = []
        for i in range(n_dec):
            cur = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            steps.append(m_k.decode_step(params, cache, toks[:, s + i], cur)[0])
        dec = torch.stack(steps, 1)
        del cache
        full, _ = m_k.forward(params, toks, tpos)
        err3, tol3 = within_std("qwen2-vl decode vs forward, text positions (bf16)", dec,
                                full[:, s:])
    launches = ops.launch_counts()
    for name in ("flash_attention", "decode_attention"):
        if launches[name] < 1:
            raise AssertionError(f"mrope: {name} was never launched")
    log(f"mrope bf16 B={b} S={s}: forward {times['forward_ms']:.3f} ms, prefill "
        f"{times['prefill_ms']:.3f} ms, decode {times['decode_step_ms']:.3f} ms a step "
        f"(eager); kernel vs dense: forward max_abs_err={err:.3e} (tol {tol:.3e}), "
        f"prefill+{n_dec} decode {err2:.3e} (tol {tol2:.3e}); decode vs forward (text) "
        f"{err3:.3e} (tol {tol3:.3e}); tolerances {BF16_LOGIT_TOL_STD} x the logits' std; peak {torch.cuda.max_memory_allocated()} "
        f"bytes; launches {json.dumps(launches)}, by shape {json.dumps(by_shape)}")
    report["mrope"] = dict(launches=launches, by_shape=dict(by_shape), n_params=n_params,
                           weights_bytes=w_bytes,
                           kernel_vs_dense=[err, tol], decode_kernel_vs_dense=[err2, tol2],
                           decode_vs_forward=[err3, tol3], **times)
    del params, dec, full
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: training (granite-3-2b), the flash backward kernel
# ---------------------------------------------------------------------------


def bwd_case(torch, gen, dtype, b, s, skv, h, kv, d, causal, pos=None, window=None):
    """The forward's log-sum-exp and the backward kernel against their plain
    versions (the backward on the kernel's own O and LSE), and two backward
    calls torch.equal. Returns (kernel inputs, mask kwargs, max abs err)."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels.ref import flash_attention_fwd_lse_plain

    q, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((b, skv, kv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    kw = dict(causal=causal) if pos is None else dict(causal=causal, q_pos=pos, kv_pos=pos)
    if window is not None:
        kw["window"] = window
    name = str(dtype).split(".")[-1]
    label = (f"flash bwd B={b} S={s} S_kv={skv} H={h} KV={kv} D={d} causal={causal} "
             f"window={window} {name}")
    out, lse = fk.flash_attention_lse(q, k, v, **kw)
    _, lse_p = flash_attention_fwd_lse_plain(q, k, v, **kw)
    assert_close(f"{label} forward LSE", lse, lse_p, TOL[name])
    del lse_p
    got = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    want = fb.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for g_name, g, a, w in zip(("dQ", "dK", "dV"), got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"{label}: two calls differ in {g_name}")
        err = max(err, assert_close(f"{label} {g_name}", g, w, TOL[name]))
    del got, again, want
    return (q, k, v, out, do, lse), kw, err


def time_bwd(torch, label, inp, kw, n_pairs, report_err, sdpa_kw):
    """Device ms of the backward kernel and of its previous design, in turns
    (CUDA-graph replays over copies past L2), the kernel's eager ms, the
    plain version's eager ms, and the backward of one SDPA call on the
    same inputs (torch.autograd.grad on a retained graph, eager,
    event-timed), with the bound: each input read and each output written
    once, 10 D flops per (query, key) pair and head (five products)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd as fb

    q, k, v, out, do, lse = inp
    esz = q.element_size()
    inputs = copies(inp, (2 * q.numel() + 2 * k.numel() + out.numel()) * esz)
    run_k = lambda *x: fb.flash_attention_bwd(*x, **kw)
    run_p = lambda *x: fb.flash_attention_bwd_plain(*x, **kw)
    run_prev = lambda *x: fb.previous_design(*x, **kw)
    ms, previous_ms = in_turns(run_k, run_prev, inputs)
    split = {name: launch_split(torch, fn, inputs)
             for name, fn in (("kernel", run_k), ("previous", run_prev))}
    eager_ms = time_ms(run_k, inputs)
    plain_ms = time_ms(run_p, inputs, iters=3, warmup=1)
    lib = []
    for q_, k_, v_, _o, do_, _l in inputs:
        leaves = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q_, k_, v_)]
        o_ = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
        lib.append((o_, leaves, do_.transpose(1, 2).contiguous()))
    run_lib = lambda o_, leaves, do_: torch.autograd.grad(o_, leaves, do_, retain_graph=True)
    library_ms = time_ms(run_lib, lib)
    del lib
    b, s, h, d = q.shape
    nbytes = (4 * q.numel() + 4 * k.numel()) * esz + lse.numel() * 4
    flops = 10 * h * d * n_pairs
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"{label}: kernel {ms:.4f} ms (eager calls {eager_ms:.4f}), previous design "
        f"{previous_ms:.4f} ms (in turns), plain {plain_ms:.4f} ms, SDPA backward "
        f"{library_ms:.4f} ms (eager), bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, "
        f"{flops} flops; computed as 14 D a pair: {flops * 1.4 / ms / 1e9:.1f} TFLOP/s)")
    for name, parts in split.items():
        log(f"  {name} launches (torch.profiler, eager): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in parts.items()))
    return dict(shape=label, max_abs_err=report_err, ms=ms, previous_ms=previous_ms,
                eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, split=split)


def backward_kernel_checks(torch, report):
    """The flash backward kernel at the training path's shapes: granite-3-2b's
    (B = 8, S = 1024, H = 32, KV = 8, D = 64, causal) in bf16 and float32,
    whisper-large-v3's encoder (S = 1500, non-causal) and decoder cross
    (S = 448, S_kv = 1500), qwen2-vl-72b's (B = 8, S = 512, H = 64, KV = 8,
    D = 128) on the mrope phase's position ids, recurrentgemma-9b's local
    attention (B = 1, S = 4096, H = 16, KV = 1, D = 256, window 2048: the
    bf16 D > 128 wide route, its dK/dV split over the group's heads) and
    gemma3-12b's layout (B = 1, S = 4096, H = 16, KV = 8, D = 256, window
    1024: the wide route unsplit); each against its plain version,
    deterministic, timed in turns with its previous design (the first
    design's mma.sync kernels) and beside SDPA's backward (an explicit mask
    for positions and the window), and each design's launches timed apart
    with torch.profiler."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    granite = (b, s, s, 32, 8, 64, True)
    inp, kw, err32 = bwd_case(torch, gen, torch.float32, *granite)
    log(f"flash bwd granite float32 B={b} S={s}: max_abs_err={err32:.3e}")
    del inp
    qpos = qwen_vl_positions(torch, 8, PREFILL_SEQ, [0, 17, 64, 100, 128, 200, 240, 253])[0]
    qpos = qpos.contiguous()
    cases = [
        ("granite train", granite, None, dict(is_causal=True, enable_gqa=True)),
        ("whisper encoder", (8, WHISPER_FRAMES, WHISPER_FRAMES, 20, 20, 64, False), None, {}),
        ("whisper cross", (8, WHISPER_DEC_SLOTS, WHISPER_FRAMES, 20, 20, 64, False), None, {}),
        ("qwen2-vl", (8, PREFILL_SEQ, PREFILL_SEQ, 64, 8, 128, True), qpos, None),
        ("recurrentgemma swa", (1, RGEMMA_TRAIN_SEQ, RGEMMA_TRAIN_SEQ, 16, 1, 256, True), None,
         None),
        ("gemma3-12b swa", (1, GEMMA3_SEQ, GEMMA3_SEQ, 16, 8, 256, True), None, None),
    ]
    windows = {"recurrentgemma swa": RGEMMA_WINDOW, "gemma3-12b swa": GEMMA3_WINDOW}
    records = []
    for label, shape, pos, sdpa_kw in cases:
        window = windows.get(label)
        inp, kw, err = bwd_case(torch, gen, torch.bfloat16, *shape, pos=pos, window=window)
        bb, ss, skv, causal = shape[0], shape[1], shape[2], shape[6]
        if pos is not None:
            mask = pos[:, None, :] <= pos[:, :, None]
            n_pairs = int(mask.sum())
            sdpa_kw = dict(attn_mask=mask[:, None], enable_gqa=True)
        elif window is not None:
            i = torch.arange(ss, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            n_pairs = bb * int(mask.sum())
            sdpa_kw = dict(attn_mask=mask, enable_gqa=True)
        else:
            n_pairs = bb * (ss * (ss + 1) // 2 if causal else ss * skv)
        log(f"flash bwd {label} bf16 {tuple(shape)} window={window}: max_abs_err={err:.3e}, "
            f"two calls equal")
        records.append(time_bwd(torch, f"flash bwd {label} B={bb} S={ss} S_kv={skv} "
                                f"H={shape[3]} KV={shape[4]} D={shape[5]} window={window} bf16",
                                inp, kw, n_pairs, err, sdpa_kw))
        del inp
        gc.collect()
        torch.cuda.empty_cache()
    main = records[0]
    report["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:148",
        gradient_of="src/repro/models/attention.py:117",
        max_abs_err=main["max_abs_err"], ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=main["library_ms"],
        previous_ms=main["previous_ms"], f32_max_abs_err=err32, shape=main["shape"],
        shapes=records[1:])


def wkv6_bwd_case(torch, gen, b, s, dtype, w_dtype, with_state, with_d_state=True):
    """wkv6_bwd at rwkv6-1.6b's heads (H = 32, K = V = 64) against autograd
    through the plain forward (``ref.wkv6_ref``), cotangents on o and (with
    ``with_d_state``) the last state; two calls torch.equal. Returns
    (the kernel's arguments, max abs err)."""
    from repro_torch.kernels import wkv6_bwd as wb
    from repro_torch.kernels.ref import wkv6_ref

    h, k = 32, 64
    r, kk, v, w, u, state = wkv6_inputs(torch, gen, b, s, h, k, dtype, w_dtype, with_state)
    do = torch.randn((b, s, h, k), generator=gen, device="cuda").to(dtype)
    ds = torch.randn((b, h, k, k), generator=gen, device="cuda") if with_d_state else None
    ins = [r, kk, v, w, u] + ([state] if with_state else [])
    leaves = [x.clone().requires_grad_() for x in ins]
    out, last = wkv6_ref(*leaves[:5], leaves[5] if with_state else None)
    loss = (out.float() * do.float()).sum() + ((last * ds).sum() if with_d_state else 0.0)
    want = torch.autograd.grad(loss, leaves)
    del out, last, loss, leaves
    args = (r, kk, v, w, u, do, state, ds)
    got = wb.wkv6_bwd(*args)
    again = wb.wkv6_bwd(*args)
    torch.cuda.synchronize()
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    label = (f"wkv6 bwd B={b} S={s} H={h} K=V={k} r/k/v {name} w {str(w_dtype)[6:]} "
             f"state={with_state} d_state={with_d_state}")
    # du sums B S terms r_t k_t (do_t . v_t) of both signs per (h, k), in
    # float32 on both sides from the same inputs: two summation orders
    # differ by a few float32 eps times the sum of the terms' magnitudes
    # (du_scale), so du is held at the usual tolerance plus DU_EPS times
    # that sum, in both dtypes. A du that is zero, scaled or missing terms
    # still fails.
    terms = (r.float() * kk.float() * (do.float() * v.float()).sum(-1, keepdim=True)).abs()
    du_scale = terms.sum((0, 1))
    err = 0.0
    for g_name, g, a, wnt in zip(("dr", "dk", "dv", "dw", "du", "d_state0"), got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"{label}: two calls differ in {g_name}")
        if g_name == "du":
            e = (g.float() - wnt.float()).abs()
            bound_du = TOL[name] * (1 + wnt.float().abs()) + DU_EPS * du_scale
            if not bool((e <= bound_du).all()):
                raise AssertionError(f"{label} du: max abs err {e.max().item():.3e} beyond tol "
                                     f"{TOL[name]} plus {DU_EPS} of its terms' magnitude")
            log(f"{label} du: max abs err {e.max().item():.3e}, at most "
                f"{(e / bound_du).max().item():.3f} of its bound; terms' magnitude up to "
                f"{du_scale.max().item():.1f}, |du| up to {wnt.float().abs().max().item():.1f}")
            err = max(err, e.max().item())
            continue
        err = max(err, assert_close(f"{label} {g_name}", g, wnt, TOL[name]))
    if (got[5] is None) == with_state:
        raise AssertionError(f"{label}: d_state0 returned for no state, or missing")
    log(f"{label}: max_abs_err={err:.3e} against autograd through wkv6_ref, two calls equal")
    return args, err


def rglru_bwd_case(torch, gen, b, s, d, dtype, with_h0, with_d_last=True, a=None,
                   exact=False):
    """rglru_bwd against autograd through the plain forward
    (``ref.rglru_ref``), cotangents on h and (with ``with_d_last``) the last
    h, the kernel reading h_{t-1} from the forward kernel's output; two
    calls torch.equal. In float32 it is also bit for bit its route's plain
    twin (``rglru_bwd_plain`` streaming, ``rglru_bwd_chunked_plain``
    chunked) and, chunked, within 2e-5 of the sequential one. ``a``
    replaces the drawn decays. With ``exact`` (decays a hair below 1) the
    oracle is the plain backward in float64 on the same h: the kernel no
    further from it than the float32 sequential backward, within 2e-5
    (``float64_departure``). Returns (the kernel's arguments, max abs err,
    or the float64 departure)."""
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels import rglru_bwd as rb
    from repro_torch.kernels.ref import rglru_bwd_chunked_plain

    drawn, x, h0 = rglru_inputs(torch, gen, b, s, d, dtype, with_h0)
    a = drawn if a is None else a.to(dtype)
    dh = torch.randn((b, s, d), generator=gen, device="cuda").to(dtype)
    dlast = torch.randn((b, d), generator=gen, device="cuda") if with_d_last else None
    leaves = [a.clone().requires_grad_(), x.clone().requires_grad_()]
    leaves += [h0.clone().requires_grad_()] if with_h0 else []
    hs, last = rk.rglru_scan_plain(*leaves)
    loss = (hs.float() * dh.float()).sum() + ((last * dlast).sum() if with_d_last else 0.0)
    want = torch.autograd.grad(loss, leaves)
    del hs, last, loss, leaves
    h, _ = rk.rglru_scan(a, x, h0)
    args = (a, h, dh, dlast, h0)
    got = rb.rglru_bwd(*args)
    again = rb.rglru_bwd(*args)
    plan = rk.route(a)
    twin = (rb.rglru_bwd_plain(*args) if plan is None
            else rglru_bwd_chunked_plain(*args, chunk=plan[0]))
    torch.cuda.synchronize()
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    route = "streaming" if plan is None else f"chunked L={plan[0]} n={plan[1]}"
    label = f"rglru bwd B={b} S={s} D={d} {name} h0={with_h0} d_last={with_d_last} [{route}]"
    err = 0.0
    for g_name, g, a_, tw in zip(("da", "db", "dh0"), got, again, twin):
        if not torch.equal(g, a_):
            raise AssertionError(f"{label}: two calls differ in {g_name}")
        if name == "float32" and not torch.equal(g, tw):
            raise AssertionError(f"{label}: {g_name} not bit for bit its route's plain twin")
    if exact:
        w64 = rb.rglru_bwd_plain(*(None if t is None else t.double() for t in args))
        seq = rb.rglru_bwd_plain(*args)
        for g_name, g, sq, w in zip(("da", "db", "dh0"), got, seq, w64):
            dep, dep_seq = float64_departure(g, w), float64_departure(sq, w)
            if not dep <= dep_seq + TOL[name]:
                raise AssertionError(f"{label} {g_name}: {dep:.3e} from the float64 backward, "
                                     f"the float32 sequential one {dep_seq:.3e}")
            log(f"{label} {g_name}: from the float64 backward {dep:.3e} (the float32 "
                f"sequential one {dep_seq:.3e}), two calls equal")
            err = max(err, dep)
        return args, err
    for g_name, g, wnt in zip(("da", "db", "dh0"), got, want):
        err = max(err, assert_close(f"{label} {g_name}", g, wnt, TOL[name]))
    if plan is not None:
        seq = rb.rglru_bwd_plain(*args)
        for g_name, g, sq in zip(("da", "db", "dh0"), got, seq):
            assert_close(f"{label} {g_name} (sequential twin)", g, sq, TOL[name])
    log(f"{label}: max_abs_err={err:.3e} against autograd through rglru_ref, two calls equal")
    return args, err


def rglru_bwd_checks(torch, report):
    """rglru_bwd on both routes (recurrentgemma-9b's training shape B = 1, S
    = 4096, D = 4096 float32 without states as the step calls it; B = 2, S
    = 1000 with states in both dtypes; ragged D = 520; the served batch's
    B = 8, S = 512 streaming; extreme decays), then timed at the training
    shape in turns with ``previous_design`` (the streaming kernel), each
    design's launches apart (``launch_split``), beside its plain version
    and its bound: a, h, dh read and da, db, dh0 written once."""
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels import rglru_bwd as rb

    gen = torch.Generator(device="cuda").manual_seed(23)
    f32, bf16 = torch.float32, torch.bfloat16
    bs, ss, d = 1, RGEMMA_TRAIN_SEQ, 4096
    main, err_f32 = rglru_bwd_case(torch, gen, bs, ss, d, f32, False, with_d_last=False)
    for b_, s_, d_, with_h0 in ((2, 1000, d, True), (2, 1000, 520, True), (8, PREFILL_SEQ, d, True),
                                (8, PREFILL_SEQ, d, False)):
        err_f32 = max(err_f32, rglru_bwd_case(torch, gen, b_, s_, d_, f32, with_h0)[1])
    err = rglru_bwd_case(torch, gen, 2, 1000, d, bf16, True)[1]
    err = max(err, rglru_bwd_case(torch, gen, 8, PREFILL_SEQ, d, bf16, True)[1])
    for label, fill, exact in (("a = 1e-3 u", lambda u: u * 1e-3, False),
                               ("a = 0.99 + 0.01 u", lambda u: 0.99 + 0.01 * u, True),
                               ("a = 1 - 1e-6 u", lambda u: 1 - 1e-6 * u, True)):
        u = torch.rand((1, ss, 520), generator=gen, device="cuda")
        log(f"rglru bwd extreme decays {label}:")
        dep = rglru_bwd_case(torch, gen, 1, ss, 520, f32, True, a=fill(u), exact=exact)[1]
        err_f32 = err_f32 if exact else max(err_f32, dep)
    a, h_, dh, _, _ = main
    inputs = copies((a, h_, dh), 3 * a.numel() * 4)
    run_k, run_prev = (lambda *x: rb.rglru_bwd(*x)), (lambda *x: rb.previous_design(*x))
    ms, previous_ms = in_turns(run_k, run_prev, inputs)
    split = {name: launch_split(torch, fn, inputs)
             for name, fn in (("kernel", run_k), ("previous", run_prev))}
    plain_ms = time_ms(lambda *x: rb.rglru_bwd_plain(*x), inputs, iters=2, warmup=1)
    nbytes = 5 * a.numel() * 4 + bs * d * 4  # a, h, dh read; da, db, dh0 written
    flops = 3 * a.numel()
    bound_ms, bound_by = bound(nbytes, flops, "float32")
    plan = rk.route(a)
    log(f"rglru bwd timed B={bs} S={ss} D={d} float32 [chunked L={plan[0]} n={plan[1]}]: kernel "
        f"{ms:.4f} ms, previous design (streaming) {previous_ms:.4f} ms (in turns, "
        f"{previous_ms / ms:.2f}x), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({nbytes} bytes); no single library call")
    for name, parts in split.items():
        log(f"  {name} launches (torch.profiler, eager): " + ", ".join(
            f"{k_} {v_:.4f} ms" for k_, v_ in parts.items()))
    if not ms * 3 <= previous_ms:
        raise AssertionError(f"rglru_bwd at the training shape: {ms:.4f} ms is not 3x faster "
                             f"than its previous design's {previous_ms:.4f} ms")
    report["rglru_bwd"] = dict(
        name="rglru_bwd", route="cuda", source="src/repro_torch/kernels/csrc/rglru_bwd.cu",
        replaces="src/repro/kernels/rglru.py:94", gradient_of="src/repro/models/recurrent.py:68",
        max_abs_err=err_f32, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, previous_ms=previous_ms, bf16_max_abs_err=err, split=split,
        shape=f"B={bs} S={ss} D={d} float32")
    del main, inputs
    gc.collect()
    torch.cuda.empty_cache()


def recurrence_backward_checks(torch, report):
    """The two recurrences' backward kernels, each against autograd through
    its plain forward, in bf16 (2e-2) and float32 (2e-5), with an initial
    state and with S not a multiple of 64, deterministic; then each timed
    at its training shape (rwkv6-1.6b: B = 8, S = 1024, H = 32, K = V = 64,
    bf16 r/k/v/do, float32 w, no state, as the train step calls it;
    recurrentgemma-9b: B = 1, S = 4096, D = 4096, float32) as CUDA-graph
    replays over copies past L2, beside its plain version (eager) and its
    bound: each input read and each output written once, and for wkv6 12 K
    V float32 flops a (b, h, step) (the state recomputed, G updated, four
    products with G or S). No single PyTorch call computes either. The
    rglru_bwd part is ``rglru_bwd_checks``."""
    from repro_torch.kernels import wkv6_bwd as wb

    gen = torch.Generator(device="cuda").manual_seed(21)
    f32, bf16 = torch.float32, torch.bfloat16
    b, s = TRAIN_BATCH, TRAIN_SEQ
    main, err = wkv6_bwd_case(torch, gen, b, s, bf16, f32, False, with_d_state=False)
    err_f32 = wkv6_bwd_case(torch, gen, b, 1000, f32, f32, True)[1]
    err = max(err, wkv6_bwd_case(torch, gen, b, 1000, bf16, f32, True)[1])
    wkv6_bwd_case(torch, gen, 2, 77, bf16, bf16, True)
    r, kk, v, w, u, do, _, _ = main
    base = (r, kk, v, w, u, do)
    inputs = copies(base, sum(t.numel() * t.element_size() for t in base))
    run_k, run_prev = (lambda *x: wb.wkv6_bwd(*x)), (lambda *x: wb.previous_design(*x))
    ms, previous_ms = in_turns(run_k, run_prev, inputs)
    split = {name: launch_split(torch, fn, inputs)
             for name, fn in (("kernel", run_k), ("previous", run_prev))}
    plain_ms = time_ms(lambda *x: wb.wkv6_bwd_plain(*x), inputs, iters=2, warmup=1)
    esz, h, k = r.element_size(), r.shape[2], r.shape[3]
    # r, k, v, do, w, u read; dr, dk, dv, dw, du written (V = K).
    nbytes = 7 * r.numel() * esz + 2 * w.numel() * 4 + 2 * u.numel() * esz
    flops = 12 * k * k * b * h * s
    bound_ms, bound_by = bound(nbytes, flops, "float32")
    log(f"wkv6 bwd timed B={b} S={s} H={h} K=V={k} bf16/f32: kernel ({wb.design(r.dtype)}) "
        f"{ms:.4f} ms, previous design (sequential) {previous_ms:.4f} ms (in turns), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, {flops} "
        f"fp32 flops; {flops / ms / 1e9:.2f} TFLOP/s); no single library call")
    for name, parts in split.items():
        log(f"  {name} launches (torch.profiler, eager): " + ", ".join(
            f"{k_} {v_:.4f} ms" for k_, v_ in parts.items()))
    # One sequence (B = 1): 32 (b, h) blocks for the sequential design, 512
    # (chunk, h, b) for the chunked one.
    one = tuple(t[:1].contiguous() if t.dim() == 4 else t for t in base)
    one_in = copies(one, sum(t.numel() * t.element_size() for t in one))
    b1_ms, b1_previous_ms = in_turns(run_k, run_prev, one_in)
    b1_bound_ms = bound(nbytes // b, flops // b, "float32")[0]
    log(f"wkv6 bwd timed B=1 S={s}: kernel {b1_ms:.4f} ms, previous design {b1_previous_ms:.4f} "
        f"ms (in turns), bound {b1_bound_ms:.4f} ms")
    report["wkv6_bwd"] = dict(
        name="wkv6_bwd", route="cuda", source="src/repro_torch/kernels/csrc/wkv6_bwd.cu",
        replaces="src/repro/kernels/wkv6.py:99", gradient_of="src/repro/models/recurrent.py:263",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, previous_ms=previous_ms, f32_max_abs_err=err_f32, split=split,
        b1_ms=b1_ms, b1_previous_ms=b1_previous_ms, b1_bound_ms=b1_bound_ms,
        shape=f"B={b} S={s} H={h} K=V={k} bf16 r/k/v/do, float32 w")
    del one, one_in
    del main, base, inputs
    gc.collect()
    torch.cuda.empty_cache()

    rglru_bwd_checks(torch, report)


def train_batch(torch, data, i):
    return {k: torch.from_numpy(v).to("cuda") for k, v in data.batch(i).items()}


def expected_train_launches(cfg) -> dict:
    """Kernel launches a train step makes through ``cfg``'s layers with remat
    on: two forwards (the step's and the recompute) and one backward per
    attention, wkv6 or rglru layer, no decode; two row-norm forwards per
    block norm and one for the final norm (their backward launches
    nothing: ``RownormFn`` differentiates the plain chain)."""
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    n_attn = sum(kind in ("attn", "swa") for kind in kinds)
    n_rwkv, n_rglru = kinds.count("rwkv"), kinds.count("rglru")
    return {"decode_attention": 0, "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
            "wkv6": 2 * n_rwkv, "wkv6_bwd": n_rwkv, "rglru_scan": 2 * n_rglru,
            "rglru_bwd": n_rglru, "rownorm": 4 * cfg.n_layers + 1, "ssd_chunk": 0, "ssd_step": 0}


def train_full_width(torch, report, mid, n_layers, batch, seq):
    """``mid`` at full width, ``n_layers`` deep (None: all its layers; bf16,
    remat on), ``batch`` x ``seq`` seeded Zipf tokens, TRAIN_STEPS steps of make_train_step:
    every loss finite, the last three's mean below the first three's, and
    per step exactly ``expected_train_launches`` (for granite-3-2b's 40
    layers 80 flash forwards and 40 backward launches; for rwkv6-1.6b's 24,
    48 wkv6 and 24 wkv6_bwd; for recurrentgemma-9b's 12, 16 rglru_scan, 8
    rglru_bwd, 8 flash forwards, 4 flash backwards). Each run is a main
    path of this phase: its launch counts are the kernels line's for the
    backward kernels ``TRAIN_ROW_OWNER`` gives it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_for
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop
    from repro_torch.training.data import DataConfig, SyntheticTokens

    cfg = get_config(mid) if n_layers is None else get_config(mid, n_layers=n_layers)
    model = model_for(cfg)
    state = train_loop.init_state(model, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    n_params = sum(t.numel() for t in _leaves(state.params))
    state_bytes = sum(t.numel() * t.element_size() for t in _leaves(state))
    tcfg = train_loop.TrainConfig(adamw=opt.AdamWConfig(
        peak_lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS))
    step = train_loop.make_train_step(model, tcfg)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    log(f"train {mid}: {cfg.n_layers} layers, remat={cfg.remat}, {n_params} parameters "
        f"({cfg.param_dtype}); params + m + v {state_bytes} bytes; batch {batch} x "
        f"{seq}, peak lr {TRAIN_LR}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        tokens = train_batch(torch, data, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, tokens)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        log(f"train {mid} step {i}: loss {loss:.6f}, grad norm {float(met['grad_norm']):.4f}, "
            f"lr {float(met['lr']):.3e}, {times[-1]:.3f} ms")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {mid}: a non-finite loss in {losses}")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        raise AssertionError(f"train {mid}: loss did not descend ({first:.4f} -> {last:.4f})")
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    want = expected_train_launches(cfg)
    if per_step != want:
        raise AssertionError(f"train {mid}: launches per step {per_step}, expected {want}")
    med = sorted(times[2:])[len(times[2:]) // 2]
    n_tokens = batch * seq
    flops6 = 6 * n_params * n_tokens
    log(f"train {mid} full width x{cfg.n_layers}: median step {med:.3f} ms after 2 warm-up "
        f"steps, {n_tokens / med * 1e3:.1f} tokens/s, peak {peak} bytes ({peak / 1e9:.3f} GB); "
        f"losses {json.dumps(losses)}; mean of first 3 {first:.6f} -> last 3 {last:.6f}; "
        f"launches per step {json.dumps(per_step)}; 6 N tokens = {flops6} flops a step, "
        f"{flops6 / med / 1e9:.1f} TFLOP/s achieved, bound "
        f"{flops6 / PEAK_FLOPS['bfloat16'] * 1e3:.3f} ms")
    if mid == MID:
        log("train losses beside the first backward design's: " + ", ".join(
            f"step {i} {x:.3f} ({y:.3f})"
            for i, (x, y) in enumerate(zip(losses, FIRST_DESIGN_LOSSES))))
    for name, owner in TRAIN_ROW_OWNER.items():
        if owner == mid:
            report[name]["launches"] = launches[name]
    report.setdefault("train", {})[mid] = dict(
        n_layers=cfg.n_layers, n_params=n_params, state_bytes=state_bytes, losses=losses,
        step_ms=times, median_step_ms=med, tokens_per_s=n_tokens / med * 1e3, peak_bytes=peak,
        launches=launches, launches_per_step=per_step)
    del state, step, tokens, met
    gc.collect()
    torch.cuda.empty_cache()


# The full-width run whose launches a backward kernel's row reports.
TRAIN_ROW_OWNER = {"flash_attention_bwd": MID, "wkv6_bwd": RWKV, "rglru_bwd": RGEMMA}


def grads_vs_dense(torch, mid, n_layers, batch, seq, dtype, against="dense"):
    """``mid`` at full width, ``n_layers`` deep, parameters in ``dtype``:
    every parameter leaf's gradient through the kernels against
    impl="dense" (``against`` names it in the log), each leaf's max abs
    difference within 2e-2 of that leaf's max abs. Returns the worst
    ratio."""
    import dataclasses

    from repro_torch.checkpoint.checkpoint import leaf_paths
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model_for
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training import train_loop
    from repro_torch.training.data import DataConfig, SyntheticTokens

    cfg = get_config(mid, n_layers=n_layers, param_dtype=dtype)
    mk, md = model_for(cfg), model_for(dataclasses.replace(cfg, impl="dense"))
    state = train_loop.init_state(mk, torch.Generator(device="cuda").manual_seed(2),
                                  device="cuda")
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch, seed=1))
    toks = train_batch(torch, data, 0)["tokens"]
    leaves = tree_leaves(state.params)
    before = ops.launch_counts()
    gk = torch.autograd.grad(mk.loss(state.params, toks), leaves)
    used = {n: c - before[n] for n, c in ops.launch_counts().items()}
    if used != expected_train_launches(cfg):
        raise AssertionError(f"train {mid} x{n_layers}: kernel path launched {used}")
    gd = torch.autograd.grad(md.loss(state.params, toks), leaves)
    worst, worst_name = 0.0, None
    for (name, _), a, w in zip(leaf_paths(state.params), gk, gd):
        scale = w.float().abs().max().item()
        err = (a.float() - w.float()).abs().max().item()
        if not err <= 2e-2 * scale:
            raise AssertionError(f"train {mid}: gradient {name} kernel vs {against} {err:.3e} > "
                                 f"2e-2 x {scale:.3e}")
        if err / max(scale, 1e-30) > worst:
            worst, worst_name = err / max(scale, 1e-30), name
    log(f"train {mid} x{n_layers} {dtype}, batch {batch} x {seq}: every gradient leaf "
        f"({len(gk)}) kernel vs {against} within {worst:.3e} of its max abs ({worst_name}; "
        f"tolerance 2e-2)")
    del gk, gd, state, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return worst


@contextlib.contextmanager
def rwkv6_kernel_forward(torch):
    """While open, impl="dense" rwkv6 takes its wkv values from the wkv6
    kernel (the chunked design in bf16, as the kernel path's forward) and
    its wkv gradient from autograd through the plain recurrence on the
    same inputs, at the kernel path's rounding points (o in r's dtype,
    gradients in their inputs' dtypes), and its layer norms from the
    row-norm kernel (``RownormFn``, as the kernel path). Both paths then
    run one forward bit for bit, so their gradients differ only by
    wkv6_bwd against the plain recurrence's derivative. Yields a list that gathers, for every
    forward call, (the kernel's o against the plain o rounded to r's
    dtype: max abs difference, max abs plain o, share of elements that
    differ)."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers, recurrent

    scan, departs = recurrent.rwkv6_wkv_scan, []
    layernorm = layers.layernorm

    class KernelForward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, w, u):
            out, last = ops.wkv6(r, k, v, w, u)
            plain = scan(r, k, v, w, u)[0].to(out.dtype).float()
            diff = (out.float() - plain).abs()
            departs.append((diff.max().item(), plain.abs().max().item(),
                            (diff > 0).float().mean().item()))
            ctx.save_for_backward(r, k, v, w, u)
            ctx.set_materialize_grads(False)
            return out, last

        @staticmethod
        def backward(ctx, do, d_last):
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            with torch.enable_grad():
                out, last = scan(*leaves)
                outs, grads = [], []
                for t, g in ((out, do), (last, d_last)):
                    if g is not None:
                        outs.append(t)
                        grads.append(g.to(t.dtype))
                return torch.autograd.grad(outs, leaves, grads)

    def kernel_forward(r, k, v, w, u, state=None, *, state_out=None):
        if state is not None or state_out is not None:
            raise ValueError("rwkv6_kernel_forward: training passes no state")
        return KernelForward.apply(*(t.contiguous() for t in (r, k, v, w, u)))

    recurrent.rwkv6_wkv_scan = kernel_forward
    layers.layernorm = lambda x, w, b, eps=1e-5, impl="xla": layernorm(x, w, b, eps)
    try:
        yield departs
    finally:
        recurrent.rwkv6_wkv_scan = scan
        layers.layernorm = layernorm


def train_two_layers(torch, report):
    """At full width: every parameter leaf's gradient through the kernels
    against impl="dense" (``grads_vs_dense``) for granite-3-2b (bf16) and
    rwkv6-1.6b (float32) at 2 layers and recurrentgemma-9b (bf16) at 3 (one
    rglru, rglru, swa period), each at its full-width run's batch, and
    rwkv6-1.6b in bf16 against dense on the kernel's wkv and norm values
    (``rwkv6_kernel_forward``); then, on granite, the resume drill through CheckpointManager on a TrainState (6 steps
    straight against 3, save, restore, 3 more: torch.equal on every leaf)
    under torch.use_deterministic_algorithms(True)."""
    import shutil

    from repro_torch.checkpoint.checkpoint import CheckpointManager, leaf_paths
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_for
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop
    from repro_torch.training.data import DataConfig, SyntheticTokens

    # rwkv6 is held against dense in float32, where it runs the sequential
    # forward: in bf16 its random-weight gradients move by most of a leaf's
    # max abs when only the wkv output is rounded to bf16 (PERF.md), so a
    # bf16 dense comparison cannot tell a kernel fault. Its bf16 training
    # path (the chunked forward, then wkv6_bwd) is held against dense with
    # the kernel's forward values (rwkv6_kernel_forward). (recurrentgemma's
    # float32 flash backward stops at D = 128, and its D = 256 runs bf16.)
    for mid, n_layers, batch, seq, dtype in (
            (MID, 2, TRAIN_BATCH, TRAIN_SEQ, "bfloat16"),
            (RWKV, 2, TRAIN_BATCH, TRAIN_SEQ, "float32"),
            (RGEMMA, 3, RGEMMA_TRAIN_BATCH, RGEMMA_TRAIN_SEQ, "bfloat16")):
        worst = grads_vs_dense(torch, mid, n_layers, batch, seq, dtype)
        report["train"][mid].update(kernel_vs_dense_worst=worst, kernel_vs_dense_dtype=dtype)
    with rwkv6_kernel_forward(torch) as departs:
        worst = grads_vs_dense(torch, RWKV, 2, TRAIN_BATCH, TRAIN_SEQ, "bfloat16",
                               against="dense on the kernel's wkv and norm values")
    diff, scale, share = (max(d[i] for d in departs) for i in range(3))
    log(f"train {RWKV} x2 bf16: the chunked forward's wkv o against the plain o rounded to "
        f"bf16 in {len(departs)} calls: max abs difference {diff:.3e} (max abs o {scale:.3e}), "
        f"up to {share:.3e} of the elements differ")
    report["train"][RWKV].update(bf16_kernel_vs_witness_worst=worst,
                                 bf16_forward_departure=dict(max_abs=diff, max_abs_o=scale,
                                                             share=share))

    cfg = get_config(MID, n_layers=2)
    mk = model_for(cfg)
    init = lambda: train_loop.init_state(mk, torch.Generator(device="cuda").manual_seed(2),
                                         device="cuda")
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=1))
    tcfg = train_loop.TrainConfig(adamw=opt.AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                                        total_steps=10))
    step = train_loop.make_train_step(mk, tcfg)

    def run(st, lo, hi):
        for i in range(lo, hi):
            st, _ = step(st, train_batch(torch, data, i))
        return st

    ckdir = ROOT / "build" / "chip_smoke_train_checkpoint"
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        straight = run(init(), 0, 6)
        half = run(init(), 0, 3)
        mgr = CheckpointManager(str(ckdir), keep=1)
        mgr.save(3, half)
        mgr.wait()
        restored = mgr.restore(3, init(), device="cuda")
        train_loop.trainable(restored.params)
        resumed = run(restored, 3, 6)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    a, r = leaf_paths(straight), leaf_paths(resumed)
    if [n for n, _ in a] != [n for n, _ in r] or ".opt.step" not in dict(a):
        raise AssertionError("train resume: leaf names differ")
    for (name, x), (_, y) in zip(a, r):
        if not torch.equal(x, y):
            raise AssertionError(f"train resume: leaf {name} differs from the straight run")
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"train resume drill {MID} x2: 6 steps straight == 3 + save + restore + 3, "
        f"torch.equal on all {len(a)} leaves (deterministic algorithms on)")
    report["train"][MID].update(resume_leaves=len(a))


def train_launcher_drill(torch):
    """python -m repro_torch.launch.train --tiny on the card: crash at step 7,
    resume from the step-5 checkpoint, finish; a straight run beside it."""
    import os
    import shutil

    base = [sys.executable, "-m", "repro_torch.launch.train", "--tiny", "--steps", "12",
            "--batch", "2", "--seq", "32", "--ckpt-every", "5"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dirs = [ROOT / "build" / f"chip_smoke_launcher_{n}" for n in ("drill", "straight")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)

    def run(args):
        return subprocess.run(base + args, capture_output=True, text=True, env=env,
                              cwd=str(ROOT), timeout=300)

    r1 = run(["--ckpt-dir", str(dirs[0]), "--fail-at", "7"])
    if r1.returncode == 0 or "simulated failure at step 7" not in r1.stdout + r1.stderr:
        raise AssertionError(f"launcher: no simulated failure: {r1.stdout[-800:]} "
                             f"{r1.stderr[-800:]}")
    r2 = run(["--ckpt-dir", str(dirs[0])])
    if r2.returncode != 0 or "resuming from checkpoint step 5" not in r2.stdout:
        raise AssertionError(f"launcher: resume failed: {r2.stdout[-800:]} {r2.stderr[-1500:]}")
    r3 = run(["--ckpt-dir", str(dirs[1])])
    if r3.returncode != 0:
        raise AssertionError(f"launcher: straight run failed: {r3.stderr[-1500:]}")
    mesh_line = "mesh {'data': 1, 'model': 1} on cuda"
    if any(mesh_line not in r.stdout for r in (r2, r3)):
        raise AssertionError(f"launcher: not trained on the host mesh ({mesh_line!r} missing)")
    digest = lambda out: [ln for ln in out.splitlines() if ln.startswith("final state digest")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    if len(digest(r2.stdout)) != 1 or digest(r2.stdout) != digest(r3.stdout):
        raise AssertionError(f"launcher: resumed {digest(r2.stdout)} != straight "
                             f"{digest(r3.stdout)}")
    log("launcher drill on the card, on the (1, 1) host mesh: crashed at step 7, resumed from "
        "step 5, finished, its final state digest equal to a straight run's\n  "
        + "\n  ".join(r2.stdout.strip().splitlines()[-4:]))


def phase_train(torch, report):
    backward_kernel_checks(torch, report)
    recurrence_backward_checks(torch, report)
    train_full_width(torch, report, MID, None, TRAIN_BATCH, TRAIN_SEQ)
    train_full_width(torch, report, RWKV, None, TRAIN_BATCH, TRAIN_SEQ)
    train_full_width(torch, report, RGEMMA, RGEMMA_TRAIN_LAYERS, RGEMMA_TRAIN_BATCH,
                     RGEMMA_TRAIN_SEQ)
    train_two_layers(torch, report)
    train_launcher_drill(torch)

# The sharding phase: the host mesh, the meshed train step against the
# unmeshed one, MoE's local path, and two dry-run cells.
SHARD_TRAIN_STEPS = 3
SHARD_MOE_LAYERS = 2
SHARD_MOE_BATCH, SHARD_MOE_SEQ = 8, 512
DRYRUN_CELLS = (
    ["--arch", MID, "--shape", "train_4k", "--mesh", "both"],
    ["--arch", "llama4-maverick-400b-a17b", "--shape", "decode_32k", "--opt", "moe_local"],
)
DRYRUN_TIMEOUT_S = 420


def sharded_train_arm(torch, mesh, meshed: bool):
    """SHARD_TRAIN_STEPS AdamW steps of full-width granite-3-2b (40 layers,
    TRAIN_BATCH x TRAIN_SEQ, remat on) from the seed-0 state: on the host
    mesh (state laid out by shardings_for_state, the batch by
    batch_sharding, the resolver installed) or unmeshed. Returns (losses,
    step ms, launches per step, the final state as full tensors)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import model_for
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop
    from repro_torch.training.data import DataConfig, SyntheticTokens

    cfg = get_config(MID)
    model = model_for(cfg)
    tcfg = train_loop.TrainConfig(adamw=opt.AdamWConfig(
        peak_lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS))
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    state = train_loop.init_state(model, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    if meshed:
        state = train_loop.place_state(state, train_loop.shardings_for_state(model, mesh))
        shd.install_activation_resolver(mesh)
    step = train_loop.make_train_step(model, tcfg)
    losses, times, launches = [], [], []
    try:
        for i in range(SHARD_TRAIN_STEPS):
            batch = train_batch(torch, data, i)
            if meshed:
                batch = train_loop.place_batch(batch, mesh)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append(ops.launch_counts())
    finally:
        shd.clear_activation_resolver()
    return losses, times, launches, train_loop.full_state(state), cfg


def sharded_train(torch, mesh, report):
    """The meshed train step against the unmeshed one from one initial state
    (deterministic algorithms on in both): every loss and every state leaf
    equal bit for bit (a (1, 1) mesh moves nothing), flash forward and
    backward and row-norm launches per step equal and as expected; logs
    both arms' step ms."""
    torch.use_deterministic_algorithms(True)
    try:
        plain_losses, plain_ms, plain_launches, plain_state, cfg = sharded_train_arm(
            torch, mesh, meshed=False)
        want = [t.detach().cpu() for t in _leaves(plain_state)]
        del plain_state
        gc.collect()
        torch.cuda.empty_cache()
        mesh_losses, mesh_ms, mesh_launches, mesh_state, _ = sharded_train_arm(
            torch, mesh, meshed=True)
    finally:
        torch.use_deterministic_algorithms(False)
    got = list(_leaves(mesh_state))
    unequal = {}
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach()
        if g.dtype != w.dtype or tuple(g.shape) != tuple(w.shape):
            raise AssertionError(f"sharding: leaf {i} is {g.dtype} {tuple(g.shape)}, unmeshed "
                                 f"{w.dtype} {tuple(w.shape)}")
        wc = w.to("cuda")
        if not torch.equal(g, wc):
            unequal[i] = float((g.float() - wc.float()).abs().max())
        del wc
    log(f"sharding: granite-3-2b x{cfg.n_layers} full width, {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{SHARD_TRAIN_STEPS} steps; losses meshed {json.dumps(mesh_losses)} unmeshed "
        f"{json.dumps(plain_losses)}; step ms meshed {json.dumps(mesh_ms)} unmeshed "
        f"{json.dumps(plain_ms)}; {len(got)} state leaves, {len(unequal)} not bit-equal "
        f"{json.dumps(unequal)}")
    if mesh_losses != plain_losses or unequal:
        raise AssertionError(f"sharding: the meshed steps are not the unmeshed ones bit for "
                             f"bit: losses {mesh_losses} vs {plain_losses}, leaves {unequal}")
    expected = expected_train_launches(cfg)
    for name in ("flash_attention", "flash_attention_bwd", "rownorm"):
        per_mesh = [c[name] for c in mesh_launches]
        per_plain = [c[name] for c in plain_launches]
        if per_mesh != per_plain or any(n != expected[name] for n in per_mesh):
            raise AssertionError(f"sharding: {name} launches per step meshed {per_mesh}, "
                                 f"unmeshed {per_plain}, expected {expected[name]}")
    med = lambda xs: sorted(xs[1:])[len(xs[1:]) // 2]
    log(f"sharding: launches per step meshed {json.dumps(mesh_launches[-1])}; median step "
        f"after the first, meshed {med(mesh_ms):.3f} ms, unmeshed {med(plain_ms):.3f} ms")
    report["sharding"] = dict(losses=mesh_losses, unmeshed_losses=plain_losses,
                              meshed_step_ms=mesh_ms, unmeshed_step_ms=plain_ms,
                              launches=mesh_launches, bit_equal=not unequal)


def mixtral_local_moe(torch, mesh, report):
    """mixtral-8x7b at full width, SHARD_MOE_LAYERS layers, bf16: one forward
    with set_moe_mesh(host mesh), through MoE's local path (counted), against
    the global path; the logits and the aux loss equal bit for bit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model_for, moe, sharding_hooks

    cfg = get_config(MIXTRAL, n_layers=SHARD_MOE_LAYERS)
    model = model_for(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (SHARD_MOE_BATCH, SHARD_MOE_SEQ), generator=gen,
                           device="cuda")
    with torch.no_grad():
        want, want_aux = model.forward(params, tokens)
        moe.local_calls = 0
        sharding_hooks.set_moe_mesh(mesh)
        try:
            got, got_aux = model.forward(params, tokens)
        finally:
            sharding_hooks.clear_moe_mesh()
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    n_moe = sum(kind in ("attn", "swa") for kind in kinds)
    calls = moe.local_calls
    log(f"sharding: mixtral-8x7b x{cfg.n_layers} full width, {SHARD_MOE_BATCH} x "
        f"{SHARD_MOE_SEQ}: local path calls {calls}; logits bit-equal "
        f"{torch.equal(got, want)}, aux {float(got_aux)} vs global {float(want_aux)}")
    if calls != n_moe:
        raise AssertionError(f"sharding: MoE's local path ran {calls} times, expected {n_moe}")
    if not torch.equal(got, want) or not torch.equal(got_aux, want_aux):
        raise AssertionError(
            f"sharding: mixtral local path != global path: logits max diff "
            f"{float((got - want).abs().max())}, aux {float(got_aux)} vs {float(want_aux)}")
    report.setdefault("sharding", {})["moe_local_calls"] = calls
    del params


def dryrun_cells(torch, report):
    """The dry run (python -m repro_torch.launch.dryrun) on DRYRUN_CELLS, each
    in a subprocess on the CPU over a fake group: every cell OK; prints each
    cell's per-rank bytes, roofline terms and seconds."""
    import shutil

    out = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    cells = []
    for args in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                            "--out", str(out)], capture_output=True, text=True, env=env,
                           cwd=str(ROOT), timeout=DRYRUN_TIMEOUT_S)
        dt = time.perf_counter() - t0
        for ln in r.stdout.splitlines():
            if ln.startswith(("OK", "FAIL")):
                log(f"dryrun {ln}")
        log(f"dryrun {' '.join(args)}: exit {r.returncode} in {dt:.3f} s")
        if r.returncode != 0:
            raise AssertionError(f"dryrun {' '.join(args)} failed: {r.stdout[-1500:]} "
                                 f"{r.stderr[-2500:]}")
    for path in sorted(out.glob("*.json")):
        c = json.loads(path.read_text())
        r = c["roofline"]
        m = c["memory_analysis"]
        cells.append(c)
        log(f"dryrun cell {path.stem}: ok={c['ok']} args/rank {m['argument_size_in_bytes']} B, "
            f"outputs/rank {m['output_size_in_bytes']} B; compute {r['compute_s']:.6e} s, "
            f"memory {r['memory_s']:.6e} s, collective {r['collective_s']:.6e} s, dominant "
            f"{r['dominant']}; collectives {json.dumps(c['counts']['collectives']['calls'])}; "
            f"run {c['run_s']} s (reckoned from the H100's rates, not measured)")
    if len(cells) != 3 or not all(c["ok"] for c in cells):
        raise AssertionError(f"dryrun: expected 3 OK cells, got "
                             f"{[(c['arch'], c['mesh'], c['ok']) for c in cells]}")
    shutil.rmtree(out, ignore_errors=True)
    report.setdefault("sharding", {})["dryrun"] = [
        {k: c[k] for k in ("arch", "shape", "mesh", "opt", "ok", "run_s")} for c in cells]


def phase_sharding(torch, report):
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy_process_group, make_host_mesh

    mesh = make_host_mesh()
    try:
        log(f"sharding: host mesh {mesh} on backend {dist.get_backend()}, "
            f"{dist.get_world_size()} rank(s)")
        if dist.get_backend() != "nccl" or tuple(mesh.mesh.shape) != (1, 1):
            raise AssertionError(f"sharding: expected a (1, 1) NCCL mesh, got {mesh} on "
                                 f"{dist.get_backend()}")
        sharded_train(torch, mesh, report)
        gc.collect()
        torch.cuda.empty_cache()
        mixtral_local_moe(torch, mesh, report)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        destroy_process_group()
    dryrun_cells(torch, report)


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
    # cuBLAS's deterministic workspace, for the train phase's resume drill
    # under torch.use_deterministic_algorithms (read before cuBLAS starts).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
                    "wkv6": "HMMA", "flash_attention_bwd": "HGMMA",
                    "wkv6_bwd": "HMMA"}.get(name)
            if need and counts[need] < 1:
                raise AssertionError(f"{name}: no {need} in its SASS")
            if name in ("rglru", "rglru_bwd"):
                missing = [k for k in ("summary_kernel", "carry_kernel", "finish_kernel")
                           if k not in text]
                if missing:
                    raise AssertionError(f"{name}: chunked route kernels {missing} not built")
            if name == "flash_attention_bwd":
                spills = wgmma_spills(text)
                log(f"  wgmma kernels of {name}: {json.dumps(spills)}")
                wide = [k for k in spills if "wide_wgmma" in k]
                if not spills or any(spills.values()) or len(wide) != 4:
                    raise AssertionError(f"{name}: a wgmma kernel spills (or the four wide "
                                         f"ones are not all built): {spills}")
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
            if name in report:  # the served kernels' rows; the backward's comes from train
                report[name]["launches"] = n
    with Phase("hybrid"):
        phase_hybrid(torch, report)
    with Phase("serve_chunked"):
        served = phase_serve(torch, DECODE_SEQ, {"decode": 2, "prefill": 1}, frames=8,
                             deadline_factor=6.0, chunk_depth=8)
        log("served chunked: " + json.dumps(served, sort_keys=True))
    with Phase("cluster"):
        phase_cluster(torch)
    with Phase("faults"):
        phase_faults(torch)
    with Phase("gateway"):
        phase_gateway(torch)
    with Phase("transport"):
        phase_transport(torch)
    with Phase("serve_moe"):
        phase_serve_moe(torch)
    with Phase("serve_zoo"):
        phase_serve_zoo(torch, report)
    with Phase("multitenant_driver"):
        phase_multitenant_driver(torch, report)
    with Phase("examples"):
        phase_examples()
    with Phase("encdec"):
        phase_encdec(torch, report)
    with Phase("mrope"):
        phase_mrope(torch, report)
    with Phase("train"):
        phase_train(torch, report)
    with Phase("sharding"):
        phase_sharding(torch, report)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "previous_ms")
    names = ("decode_attention", "flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd",
             "rglru_scan", "rglru_bwd", "rownorm")
    extra = ("b1_ms", "b1_previous_ms", "b1_bound_ms", "decode_ms", "decode_previous_ms",
             "train_ms", "train_previous_ms", "train_bound_ms",
             "decode_bound_ms", "gradient_of", "f32_max_abs_err", "bf16_max_abs_err", "shape",
             "shapes")
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
