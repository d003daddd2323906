"""Port tests that need an NVIDIA GPU: the CUDA kernels and the engine on
the card, each against the port's own plain path. They carry the ``cuda``
marker and skip without a GPU; on a GPU machine (which has no JAX, so
this file imports none):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import tiny
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain, plan_splits
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.ref import decode_attention_split_plain, wkv6_chunked_plain
from repro_torch.kernels.rglru import rglru_scan_plain
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models.layers import tree_leaves
from repro_torch.serving.engine import InferenceEngine

MID = "granite-3-2b"
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 100, 8, 32), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, 100, 2, 32), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, 100, 2, 32), generator=g, device=cuda).to(dtype)
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, window=23)
    want = flash_attention_plain(q, k, v, window=23)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])

    qd = torch.randn((3, 1, 16, 64), generator=g, device=cuda).to(dtype)
    ck = torch.randn((3, 500, 2, 64), generator=g, device=cuda).to(dtype)
    cv = torch.randn((3, 500, 2, 64), generator=g, device=cuda).to(dtype)
    cursor = torch.tensor([499, 250, 0], dtype=torch.int32, device=cuda)
    pos = torch.arange(500, dtype=torch.int32, device=cuda).expand(3, 500).contiguous()
    valid = pos <= cursor[:, None]
    active = torch.tensor([True, True, False], device=cuda)
    got = ops.decode_attention(qd, ck, cv, cursor, pos, valid, active, window=13)
    want = decode_attention_plain(qd, ck, cv, cursor, pos, valid, active, window=13)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert float(got[2].abs().max()) == 0.0
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "decode_attention": 1, "flash_attention": 1, "wkv6": 0, "rglru_scan": 0}


# (B, S, KV, G, D, window, ring): D in {8, 16, 64, 256}, S in {1, 63, 509,
# 2048}, G in {1, 4, 16, 64}; granite's and recurrentgemma's served shapes.
DECODE_CASES = [
    (3, 1, 2, 4, 16, None, False),
    (3, 63, 1, 16, 8, None, False),
    (4, 509, 2, 4, 64, 100, False),
    (8, 2048, 8, 4, 64, None, False),
    (8, 2048, 1, 16, 256, 2048, True),
    (2, 509, 1, 64, 256, None, False),
    (3, 2048, 4, 1, 64, 300, True),
    (2, 63, 2, 64, 16, 13, True),
]


def _decode_case(cuda, dtype, case):
    """Inputs for one case: row 0 has every split but the first (or, on a
    ring, the first half of the slots) dead; the last row is inactive."""
    b, s, kv, g, d, window, ring = case
    gen = torch.Generator(device=cuda).manual_seed(s + 7 * g + d)
    h = kv * g
    q = torch.randn((b, 1, h, d), generator=gen, device=cuda).to(dtype)
    ck = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(dtype)
    cv = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(dtype)
    if ring:
        cursor = torch.randint(s, 3 * s, (b,), generator=gen, device=cuda).to(torch.int32)
        pos = torch.stack([torch.randperm(s, generator=gen, device=cuda) + int(c) - s + 1
                           for c in cursor]).to(torch.int32)
        holes = torch.rand((b, s), generator=gen, device=cuda) < 0.2
        pos = torch.where(holes, -1, pos).to(torch.int32)
        valid = pos >= 0
        valid[0, : s // 2] = False
    else:
        cursor = torch.randint(0, s, (b,), generator=gen, device=cuda).to(torch.int32)
        cursor[0] = min(5, s - 1)
        pos = torch.arange(s, dtype=torch.int32, device=cuda).expand(b, s)
        valid = pos <= cursor[:, None]
    active = torch.ones(b, dtype=torch.bool, device=cuda)
    active[-1] = False
    return (q, ck, cv, cursor, pos.contiguous(), valid.contiguous(), active), window


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "B{}-S{}-KV{}-G{}-D{}-w{}-ring{}".format(*c))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernel_on_card(cuda, dtype, case):
    """The split-S decode kernel (mma.sync in bf16, FMA in float32) against
    the plain version and its split twin, bit-identical on a repeat, exact
    0 on the inactive row, one launch counted per call."""
    args, window = _decode_case(cuda, dtype, case)
    b, s, kv = case[0], case[1], case[2]
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(*args, window=window)
    again = ops.decode_attention(*args, window=window)
    assert ops.launch_counts()["decode_attention"] == before + 2
    assert torch.equal(got, again)
    want = decode_attention_plain(*args, window=window)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    n_split = plan_splits(b, kv, s, torch.cuda.get_device_properties(cuda).multi_processor_count)[0]
    twin = decode_attention_split_plain(*args, window=window, n_split=n_split)
    torch.testing.assert_close(got.float(), twin.float(), atol=tol, rtol=tol)
    assert float(got[-1].float().abs().max()) == 0.0
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())


# (B, S, H, KV, D, causal, window)
FLASH_CASES = [
    (1, 1, 4, 4, 8, True, None),
    (2, 63, 4, 1, 16, True, 13),
    (2, 509, 16, 4, 64, True, None),
    (1, 509, 16, 1, 256, True, 2048),
    (1, 509, 64, 1, 32, False, None),
    (1, 2048, 4, 4, 64, True, 300),
    (2, 100, 8, 2, 32, False, 23),
    (8, 512, 32, 8, 64, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "B{}-S{}-H{}-KV{}-D{}-c{}-w{}".format(*c))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_card(cuda, dtype, case):
    """Flash attention (wgmma in bf16, FMA in float32) against the plain
    version, bit-identical on a repeat, one launch counted per call."""
    b, s, h, kv, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(s + h + d)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(dtype)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention"] == before + 2
    assert torch.equal(got, again)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert got.dtype == dtype


@pytest.mark.cuda
def test_engine_kernel_path_matches_dense_on_card(cuda):
    """The engine on the card: prefill tokens and arena decode logits of
    the kernel path (default impl) against impl="dense" on the same
    parameters, through pinned staging and CUDA-event step handles."""
    eng = InferenceEngine({MID: tiny(MID)}, max_slots=4, device=cuda)
    dense = InferenceEngine({MID: dataclasses.replace(tiny(MID), impl="dense")},
                            max_slots=4, device=cuda, params=eng.params)
    toks = np.random.default_rng(0).integers(0, 256, size=(3, 16)).astype(np.int32)
    a = eng.dispatch(MID, (16,), 3, "prefill", payload=toks)
    b = dense.dispatch(MID, (16,), 3, "prefill", payload=toks)
    assert a.event is not None
    assert torch.equal(a.wait()[:3], b.wait()[:3])
    slots = eng.alloc_slots(MID, 32, 3)
    assert dense.alloc_slots(MID, 32, 3) == slots
    for step in range(4):
        payload = {s: int(t) for s, t in zip(slots, toks[:, step])}
        la = eng.dispatch(MID, (32,), 3, "decode", slots=slots, payload=payload).wait()
        lb = dense.dispatch(MID, (32,), 3, "decode", slots=slots, payload=payload).wait()
        torch.testing.assert_close(la[:3], lb[:3], atol=2e-3, rtol=2e-3)
    assert eng.arena(MID, 32).cur.tolist() == [4, 4, 4, 0]
    assert eng.staging_ring("decode", MID, 32, 4)._host[0].is_pinned()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 2, 8), (2, 90, 2, 16), (1, 200, 4, 64),
                                   (2, 33, 8, 32), (8, 1, 32, 64)])
@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_kernel_matches_plain_on_card(cuda, shape, dtype, w_dtype, with_state):
    b, s, h, k = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    r, kk, v = ((rn(b, s, h, k) * 0.5).to(dtype) for _ in range(3))
    w = (torch.sigmoid(rn(b, s, h, k)) * 0.5 + 0.45).to(w_dtype)
    u = (rn(h, k) * 0.1).to(dtype)
    state = rn(b, h, k, k) * 0.1 if with_state else None
    before = ops.launch_counts()["wkv6"]
    out, last = ops.wkv6(r, kk, v, w, u, state)
    want, want_last = wkv6_plain(r, kk, v, w, u, state)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(last, want_last, atol=tol, rtol=tol)
    assert out.dtype == dtype and last.dtype == torch.float32
    if state is not None:  # in place, as the decode arena uses it
        buf = state.clone()
        out2, last2 = ops.wkv6(r, kk, v, w, u, buf, state_out=buf)
        assert last2.data_ptr() == buf.data_ptr()
        assert torch.equal(out2, out) and torch.equal(buf, last)
    assert ops.launch_counts()["wkv6"] == before + (2 if state is not None else 1)


WKV_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16)]


def _wkv_inputs(cuda, b, s, h, k, dtype, w_dtype, seed, w=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    r, kk, v = ((rn(b, s, h, k) * 0.5).to(dtype) for _ in range(3))
    if w is None:
        w = torch.sigmoid(rn(b, s, h, k)) * 0.5 + 0.45
    u = (rn(h, k) * 0.1).to(dtype)
    return r, kk, v, w.to(w_dtype), u, rn(b, h, k, k) * 0.1


def _check_wkv6(r, kk, v, w, u, state):
    """One call through ``ops`` against the plain version and, on the
    chunked path, against its plain twin; then the same call with the
    state written in place, which must agree bit for bit."""
    before = ops.launch_counts()["wkv6"]
    out, last = ops.wkv6(r, kk, v, w, u, state)
    assert ops.launch_counts()["wkv6"] == before + 1  # one per call, any design
    tol = TOL[r.dtype]
    want, want_last = wkv6_plain(r, kk, v, w, u, state)
    assert torch.isfinite(out.float()).all() and torch.isfinite(last).all()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(last, want_last, atol=tol, rtol=tol)
    if wk.uses_chunked(r.dtype, r.shape[1]):
        # The twin repeats the kernel's arithmetic: they differ by the
        # order of float32 sums and by one bf16 rounding of o at most.
        tw, tw_last = wkv6_chunked_plain(r, kk, v, w, u, state)
        torch.testing.assert_close(out.float(), tw.float(), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(last, tw_last, atol=1e-4, rtol=1e-4)
    buf = state.clone()
    out2, last2 = ops.wkv6(r, kk, v, w, u, buf, state_out=buf)
    assert last2.data_ptr() == buf.data_ptr()
    assert torch.equal(out2, out) and torch.equal(buf, last)
    return out, last


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("s", [63, 64, 65, 509, 512])
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("dtype,w_dtype", WKV_PAIRS)
def test_wkv6_designs_on_card(cuda, b, s, k, dtype, w_dtype):
    """Both designs around the chunk boundary, at rwkv6-1.6b's 32 heads
    of 64 and at 16 channels."""
    _check_wkv6(*_wkv_inputs(cuda, b, s, 32 if k == 64 else 4, k, dtype, w_dtype, b + s + k))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero", "denormal", "one", "mixed"])
@pytest.mark.parametrize("dtype,w_dtype", WKV_PAIRS)
def test_wkv6_extreme_decays_on_card(cuda, case, dtype, w_dtype):
    b, s, h, k = 2, 200, 4, 64
    shape = (b, s, h, k)
    if case == "zero":
        w = torch.zeros(shape, device=cuda)
    elif case == "denormal":
        w = torch.full(shape, 1e-40, device=cuda)
    elif case == "one":
        w = torch.ones(shape, device=cuda)
    else:  # strong and mild channels side by side in every chunk
        g = torch.Generator(device=cuda).manual_seed(9)
        strong = torch.rand(shape, generator=g, device=cuda) * 1e-2
        mild = 0.99 + torch.rand(shape, generator=g, device=cuda) * 0.01
        w = torch.where(torch.arange(k, device=cuda) % 2 == 0, strong, mild)
    _check_wkv6(*_wkv_inputs(cuda, b, s, h, k, dtype, w_dtype, len(case), w=w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K=V=12", "K=24 V=16", "unaligned"])
def test_wkv6_chunked_element_staging_on_card(cuda, case):
    """The chunked kernel stages 16 bytes at a time only when K and V are
    multiples of 8 and every pointer is 16-byte aligned; otherwise one
    element at a time. Cover the second way."""
    b, s, h = 2, 130, 4
    if case == "unaligned":  # contiguous views two bytes past an aligned start
        args = list(_wkv_inputs(cuda, b, s, h, 64, torch.bfloat16, torch.float32, 5))
        for i in range(4):
            buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype, device=cuda)
            view = buf[1:].view(args[i].shape)
            view.copy_(args[i])
            args[i] = view
        assert args[0].data_ptr() % 16
        _check_wkv6(*args)
        return
    k = 12 if case == "K=V=12" else 24
    r, kk, _, w, u, state = _wkv_inputs(cuda, b, s, h, k, torch.bfloat16, torch.float32, k)
    dv = k if k == 12 else 16
    g = torch.Generator(device=cuda).manual_seed(3)
    v = (torch.randn((b, s, h, dv), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    state = torch.randn((b, h, k, dv), generator=g, device=cuda) * 0.1
    _check_wkv6(r, kk, v, w, u, state)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 64, 512])
@pytest.mark.parametrize("dtype,w_dtype", WKV_PAIRS)
def test_wkv6_dispatch_and_repeats_on_card(cuda, s, dtype, w_dtype):
    """The design is a function of (dtype, S): the sequential shapes give
    exactly what ``previous_design`` (the sequential kernel) gives, and
    the chunked ones do not; two calls agree bit for bit on either path."""
    args = _wkv_inputs(cuda, 8, s, 32, 64, dtype, w_dtype, s)
    out, last = wk.wkv6(*args)
    again, again_last = wk.wkv6(*args)
    assert torch.equal(out, again) and torch.equal(last, again_last)
    before = wk.launches
    seq, seq_last = wk.previous_design(*args)
    assert wk.launches == before  # timing only: not counted
    same = torch.equal(out, seq) and torch.equal(last, seq_last)
    assert same is not wk.uses_chunked(dtype, s)
    assert wk.uses_chunked(dtype, s) is (dtype == torch.bfloat16 and s >= 64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 16), (2, 90, 48), (1, 256, 128), (3, 37, 520),
                                   (8, 1, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_kernel_matches_plain_on_card(cuda, shape, dtype, with_h0):
    b, s, d = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    a = (torch.sigmoid(torch.randn(shape, generator=g, device=cuda)) * 0.5 + 0.45).to(dtype)
    x = (torch.randn(shape, generator=g, device=cuda) * 0.1).to(dtype)
    h0 = torch.randn((b, d), generator=g, device=cuda) if with_h0 else None
    before = ops.launch_counts()["rglru_scan"]
    out, last = ops.rglru_scan(a, x, h0)
    want, want_last = rglru_scan_plain(a, x, h0)
    # Multiply and add are rounded separately, as in the plain version:
    # float32 agrees bit for bit, bf16 outputs differ by at most rounding.
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(last, want_last, atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == torch.float32:
        assert torch.equal(out, want) and torch.equal(last, want_last)
    assert ops.launch_counts()["rglru_scan"] == before + 1
    with pytest.raises(TypeError, match="dtype"):
        ops.rglru_scan(a, x, torch.zeros((b, d), dtype=torch.float64, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [("rwkv6-1.6b", {}), ("recurrentgemma-9b", {"n_layers": 5})])
def test_recurrent_engine_kernel_path_matches_dense_on_card(cuda, arch, kw):
    """Tiny rwkv6 / recurrentgemma in the engine on the card: the kernel
    path against impl="dense" (prefill tokens, arena decode logits past
    recurrentgemma's 16-slot ring), with the arena's state written in
    place and every kernel of the model launched."""
    cfg = tiny(arch, **kw)
    eng = InferenceEngine({arch: cfg}, max_slots=4, device=cuda)
    dense = InferenceEngine({arch: dataclasses.replace(cfg, impl="dense")},
                            max_slots=4, device=cuda, params=eng.params)
    toks = np.random.default_rng(1).integers(0, 256, size=(3, 24)).astype(np.int32)
    before = ops.launch_counts()
    a = eng.dispatch(arch, (16,), 3, "prefill", payload=toks[:, :16])
    b = dense.dispatch(arch, (16,), 3, "prefill", payload=toks[:, :16])
    assert torch.equal(a.wait()[:3], b.wait()[:3])
    slots = eng.alloc_slots(arch, 32, 3)
    assert dense.alloc_slots(arch, 32, 3) == slots
    cache = eng.arena(arch, 32).cache
    ptrs = [t.data_ptr() for e in cache["super"] for t in e.values()]
    for step in range(20):
        payload = {s: int(t) for s, t in zip(slots, toks[:, step])}
        la = eng.dispatch(arch, (32,), 3, "decode", slots=slots, payload=payload).wait()
        lb = dense.dispatch(arch, (32,), 3, "decode", slots=slots, payload=payload).wait()
        torch.testing.assert_close(la[:3], lb[:3], atol=2e-3, rtol=2e-3)
    assert [t.data_ptr() for e in cache["super"] for t in e.values()] == ptrs
    used = {n: ops.launch_counts()[n] - before[n] for n in before}
    if arch == "rwkv6-1.6b":
        assert used["wkv6"] > 0 and used["rglru_scan"] == 0
    else:
        assert used["wkv6"] == 0 and used["rglru_scan"] > 0 and used["flash_attention"] > 0
        assert used["decode_attention"] > 0


# ---------------------------------------------------------------------------
# decode steps and chunks as CUDA graphs
# ---------------------------------------------------------------------------
# One model per block kind: granite (attn), recurrentgemma at 5 layers
# (rglru and an swa ring, with a tail after it), rwkv6 (rwkv).
GRAPH_ARCHS = {"granite-3-2b": {}, "recurrentgemma-9b": {"n_layers": 5}, "rwkv6-1.6b": {}}
GSEQ = 24  # recurrentgemma's 16-slot ring wraps for rows near the end


def _graph_engine(cuda, arch, dtype, params=None, max_slots=8, chunk_depth=8):
    cfg = tiny(arch, **GRAPH_ARCHS[arch])
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    return InferenceEngine({arch: cfg}, max_slots=max_slots, chunk_depth=chunk_depth,
                           device=cuda, params=None if params is None else {arch: params})


def _leaves_of(arena):
    return tree_leaves(arena.cache) + [arena.cur, arena.active]


def _warm(eng, arch, depths=(1, 2, 4, 8)):
    """Run the step and every chunk depth in prefix mode (the profiler's
    warm-up), before any row is leased: one capture, the step graph's,
    which every chunk depth replays."""
    eng.execute(arch, (GSEQ,), eng.max_slots, "decode")
    for k in depths:
        eng.execute_chunk(arch, (GSEQ,), eng.max_slots, k)
    assert eng.stats["decode_compiles"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_replay_matches_eager_decode_step(cuda, arch, dtype):
    """A step's graph replay against the eager step on the same inputs and
    the same arena (restored in place between the two), every block kind:
    the same kernels in the same order, so bit for bit."""
    eng = _graph_engine(cuda, arch, dtype)
    slots = eng.alloc_slots(arch, GSEQ, 5, start_pos=9)
    arena = eng.arena(arch, GSEQ)
    payload = {s: 3 + 7 * s for s in slots}
    eng.dispatch(arch, (GSEQ,), 5, "decode", slots=slots, payload=payload).wait()  # captures
    snap = [t.clone() for t in _leaves_of(arena)]
    cur, active = arena.cur.clone(), arena.active.clone()
    got = eng.dispatch(arch, (GSEQ,), 5, "decode", slots=slots, payload=payload).wait()
    after = [t.clone() for t in _leaves_of(arena)]
    for t, s in zip(_leaves_of(arena), snap):
        t.copy_(s)
    tok = torch.zeros(8, dtype=torch.int32, device=cuda)
    tok[list(slots)] = torch.tensor([payload[s] for s in slots], dtype=torch.int32,
                                    device=cuda)
    want, want_cur = eng._decode_fn(arch, GSEQ)(tok, cur, active)
    arena.cur.copy_(want_cur)
    torch.cuda.synchronize()
    live = list(slots)
    assert torch.equal(got[live], want[live])
    for a, t in zip(after, _leaves_of(arena)):
        assert torch.equal(a, t)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False], ids=["replays", "first-calls"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_chunk_graph_bit_identical_to_step_graphs(cuda, arch, dtype, k, warm):
    """A k-step chunk on engine A against k single steps on twin engine B,
    with scattered leased rows, mixed cursors and an empty step: every
    arena leaf, cursors, active bitmap and each step's logits bit for
    bit; the arena's storage never moves. Warm: both sides are replays.
    Cold: the chunk is its key's first (eager) call, and so is B's first
    step, the rest replays."""
    a = _graph_engine(cuda, arch, dtype)
    b = _graph_engine(cuda, arch, dtype, params=a.params[arch])
    for e in (a, b):
        if warm:
            _warm(e, arch)
        e.alloc_slots(arch, GSEQ, 4, start_pos=2)
        e.alloc_slots(arch, GSEQ, 4, start_pos=GSEQ - 4)
        e.free_slots(arch, GSEQ, [0, 5])
    live = list(a.arena(arch, GSEQ).live)
    rows_plan = ([[1, 4], [], None, [3, 6, 7], [2], None, [1, 2, 3], [4, 7]])[:k]
    rng = np.random.default_rng(k)
    payloads = [{r: int(rng.integers(0, 256)) for r in (live if rows is None else rows)}
                for rows in rows_plan]
    ptrs = [t.data_ptr() for t in _leaves_of(a.arena(arch, GSEQ))]
    before = ops.launch_counts()
    chunk = a.decode_chunk(arch, (GSEQ,), len(live), k, slots=live, payloads=payloads,
                           step_rows=rows_plan).wait()
    steps = [b.dispatch(arch, (GSEQ,), len(live), "decode", slots=live, payload=payloads[i],
                        step_rows=rows_plan[i]).wait() for i in range(k)]
    after = ops.launch_counts()
    for la, lb in zip(_leaves_of(a.arena(arch, GSEQ)), _leaves_of(b.arena(arch, GSEQ))):
        assert torch.equal(la, lb)
    for i in range(k):
        assert torch.equal(chunk[i], steps[i])
    assert [t.data_ptr() for t in _leaves_of(a.arena(arch, GSEQ))] == ptrs
    # The chunk counts k steps' launches, as k steps do: it replays the
    # step graph, the only graph either engine holds.
    step_graph = b._graphs[("decode", arch, GSEQ)]
    assert set(a._graphs) == set(b._graphs) == {("decode", arch, GSEQ)}
    assert a._graphs[("decode", arch, GSEQ)].launches == step_graph.launches
    assert {n: after[n] - before[n] for n in after} == {
        n: 2 * k * c for n, c in step_graph.launches.items()}
    assert a.stats["decode_compiles"] == b.stats["decode_compiles"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_graphs_keep_arena_storage_count_launches_and_never_recapture(cuda, arch):
    """The arena's storage is stable across steps, allocation, frees and
    ring presentation; a replay adds the launches its capture counted (the
    eager step's own counts); no batch of a sweep captures again."""
    eng = _graph_engine(cuda, arch, torch.bfloat16)
    arena = eng.arena(arch, GSEQ)
    ptrs = [t.data_ptr() for t in _leaves_of(arena)]
    before = ops.launch_counts()
    eng.execute(arch, (GSEQ,), 8, "decode")  # eager step, then the capture
    eager = {n: c - before[n] for n, c in ops.launch_counts().items()}
    assert sum(eager.values()) > 0
    assert eng._graphs[("decode", arch, GSEQ)].launches == eager
    eng.reset_stats()
    for b in (1, 2, 3, 5, 8, 6, 4, 2, 1):
        before = ops.launch_counts()
        logits = eng.dispatch(arch, (GSEQ,), b, "decode").wait()
        assert {n: c - before[n] for n, c in ops.launch_counts().items()} == eager
        assert bool(torch.isfinite(logits[:b]).all())
    assert eng.stats["decode_compiles"] == 0
    slots = eng.alloc_slots(arch, GSEQ, 3, start_pos=4)
    for _ in range(3):
        eng.dispatch(arch, (GSEQ,), 3, "decode", slots=slots, payload={s: 1 for s in slots})
    eng.free_slots(arch, GSEQ, [slots[1]])
    eng.dispatch(arch, (GSEQ,), 2, "decode", slots=[slots[0], slots[2]]).wait()
    eng.free_slots(arch, GSEQ, [slots[0], slots[2]])
    eng.dispatch(arch, (GSEQ,), 4, "decode").wait()  # presents the rings again
    assert eng.stats["decode_compiles"] == 0
    assert [t.data_ptr() for t in _leaves_of(arena)] == ptrs


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_consecutive_replays_hold_distinct_logits(cuda, arch):
    """Handles of replays enqueued back to back, waited on only at the end,
    each hold their own step's logits (the graph's output buffer is
    overwritten by every replay), as a twin engine waiting after every
    step gives them; the same for chunks."""
    a = _graph_engine(cuda, arch, torch.float32)
    b = _graph_engine(cuda, arch, torch.float32, params=a.params[arch])
    for e in (a, b):
        _warm(e, arch, depths=(2,))
    slots = a.alloc_slots(arch, GSEQ, 4)
    assert b.alloc_slots(arch, GSEQ, 4) == slots
    toks = [{s: 11 * i + s for s in slots} for i in range(4)]
    handles = [a.dispatch(arch, (GSEQ,), 4, "decode", slots=slots, payload=t) for t in toks]
    handles.append(a.decode_chunk(arch, (GSEQ,), 4, 2, slots=slots, payloads=toks[:2]))
    handles.append(a.decode_chunk(arch, (GSEQ,), 4, 2, slots=slots, payloads=toks[2:]))
    got = [h.wait() for h in handles]
    want = [b.dispatch(arch, (GSEQ,), 4, "decode", slots=slots, payload=t).wait() for t in toks]
    want += [b.decode_chunk(arch, (GSEQ,), 4, 2, slots=slots, payloads=p).wait()
             for p in (toks[:2], toks[2:])]
    assert len({g.data_ptr() for g in got}) == len(got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_chunk_is_k_step_replays_one_capture_per_key(cuda, arch):
    """A k-step chunk on the card is k replays of the (mid, seq) step
    graph: depths 1-8 on two seqs capture one graph per seq and nothing
    per depth, a chunk replays its seq's step graph exactly k times, and
    its logits are its own (the next replay does not overwrite them)."""
    eng = _graph_engine(cuda, arch, torch.float32)
    seqs = (GSEQ, GSEQ + 8)
    for seq in seqs:
        eng.execute(arch, (seq,), 8, "decode")
        for k in (1, 2, 4, 8):
            eng.execute_chunk(arch, (seq,), 8, k)
    assert eng.stats["decode_compiles"] == len(seqs)
    assert set(eng._graphs) == {("decode", arch, seq) for seq in seqs}
    eng.reset_stats()
    graph = eng._graphs[("decode", arch, GSEQ)]
    replays = []
    real = graph.replay
    graph.replay = lambda args: replays.append(1) or real(args)
    slots = eng.alloc_slots(arch, GSEQ, 3, start_pos=1)
    for k in (1, 2, 4, 8):
        replays.clear()
        before = ops.launch_counts()
        h = eng.decode_chunk(arch, (GSEQ,), 3, k, slots=slots,
                             payloads=[{s: 5 * i + s for s in slots} for i in range(k)])
        out = h.wait()
        assert len(replays) == k
        assert {n: c - before[n] for n, c in ops.launch_counts().items()} == {
            n: k * c for n, c in graph.launches.items()}
        assert out.shape[0] == k and out.data_ptr() != graph.outputs[0].data_ptr()
        kept = out.clone()
        eng.dispatch(arch, (GSEQ,), 3, "decode", slots=slots).wait()
        assert torch.equal(out, kept)
    assert eng.stats["decode_compiles"] == 0
