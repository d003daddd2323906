"""Port tests that need an NVIDIA GPU: the CUDA kernels and the engine on
the card, each against the port's own plain path. They carry the ``cuda``
marker and skip without a GPU; on a GPU machine (which has no JAX, so
this file imports none):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import gc

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
from repro_torch.kernels.rownorm import rownorm_plain
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models.layers import tree_leaves
from repro_torch.core.bucketing import bucket
from repro_torch.serving.engine import InferenceEngine, _StepGraph

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
        "decode_attention": 1, "flash_attention": 1, "flash_attention_bwd": 0, "wkv6": 0,
        "wkv6_bwd": 0, "rglru_scan": 0, "rglru_bwd": 0, "rownorm": 0, "ssd_chunk": 0,
        "ssd_step": 0}


# (B, S, KV, G, D, window, ring): D in {8, 16, 64, 128, 256}, S in {1, 63,
# 509, 1024, 2048}, G in {1, 2, 3, 4, 5, 16, 64}; the served shapes of
# granite and recurrentgemma, then of phi4-mini (G 3), llama4-maverick
# (G 5), llama3-405b (G 16 at D 128) and gemma3-12b (G 2 at D 256: its
# 1024-slot local rings and its full caches).
DECODE_CASES = [
    (3, 1, 2, 4, 16, None, False),
    (3, 63, 1, 16, 8, None, False),
    (4, 509, 2, 4, 64, 100, False),
    (8, 2048, 8, 4, 64, None, False),
    (8, 2048, 1, 16, 256, 2048, True),
    (2, 509, 1, 64, 256, None, False),
    (3, 2048, 4, 1, 64, 300, True),
    (2, 63, 2, 64, 16, 13, True),
    (8, 2048, 8, 3, 128, None, False),
    (8, 2048, 8, 5, 128, None, False),
    (8, 2048, 8, 16, 128, None, False),
    (8, 1024, 8, 2, 256, 1024, True),
    (8, 2048, 8, 2, 256, None, False),
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
    (8, 512, 24, 8, 128, True, None),
    (8, 512, 40, 8, 128, True, None),
    (2, 512, 128, 8, 128, True, None),
    (8, 512, 16, 8, 256, True, 1024),
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
                                   (8, 1, 4096), (8, 512, 4096), (1, 4096, 4096),
                                   (2, 1000, 520)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_kernel_matches_plain_on_card(cuda, shape, dtype, with_h0):
    """The forward against the sequential plain version at the dtype's
    tolerance; in float32 bit for bit its route's plain twin (the
    sequential walk streaming, ``rglru_chunked_plain`` chunked); two calls
    torch.equal; one launch counted a call."""
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels.ref import rglru_chunked_plain

    b, s, d = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    a = (torch.sigmoid(torch.randn(shape, generator=g, device=cuda)) * 0.5 + 0.45).to(dtype)
    x = (torch.randn(shape, generator=g, device=cuda) * 0.1).to(dtype)
    h0 = torch.randn((b, d), generator=g, device=cuda) if with_h0 else None
    before = ops.launch_counts()["rglru_scan"]
    out, last = ops.rglru_scan(a, x, h0)
    again, again_last = ops.rglru_scan(a, x, h0)
    want, want_last = rglru_scan_plain(a, x, h0)
    assert torch.equal(out, again) and torch.equal(last, again_last)
    # Multiply and add are rounded separately, as in the plain version:
    # float32 agrees bit for bit with the route's twin (the chunked route's
    # carries round apart from the sequential walk), bf16 outputs differ
    # by at most rounding.
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(last, want_last, atol=TOL[dtype], rtol=TOL[dtype])
    plan = rk.route(a)
    if plan is not None:
        want, want_last = rglru_chunked_plain(a, x, h0, plan[0])
    if dtype == torch.float32:
        assert torch.equal(out, want) and torch.equal(last, want_last)
    assert ops.launch_counts()["rglru_scan"] == before + 2
    with pytest.raises(TypeError, match="dtype"):
        ops.rglru_scan(a, x, torch.zeros((b, d), dtype=torch.float64, device=cuda))


@pytest.mark.cuda
def test_rglru_routes_on_card(cuda):
    """The route rule on this card: the served prefill (8 x 512 x 4096)
    and a decode step take the streaming route, the training shape (1 x
    4096 x 4096) the chunked one; and ``previous_design`` of either kernel (the streaming one) launches
    uncounted, bit for bit the sequential plain versions."""
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels import rglru_bwd as rb

    assert rk.route(torch.empty((8, 512, 4096), device=cuda)) is None
    assert rk.route(torch.empty((8, 1, 4096), device=cuda)) is None
    assert rk.route(torch.empty((1, 4096, 4096), device=cuda)) is not None
    g = torch.Generator(device=cuda).manual_seed(5)
    shape = (1, 1000, 520)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=cuda))
    x, dh = (torch.randn(shape, generator=g, device=cuda) for _ in range(2))
    assert rk.route(a) is not None
    before = ops.launch_counts()
    h, last = rk.previous_design(a, x)
    grads = rb.previous_design(a, h, dh)
    assert ops.launch_counts() == before
    want, want_last = rglru_scan_plain(a, x)
    assert torch.equal(h, want) and torch.equal(last, want_last)
    assert all(torch.equal(gt, pt) for gt, pt in zip(grads, rb.rglru_bwd_plain(a, h, dh)))


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
# (rglru and an swa ring, with a tail after it), rwkv6 (rwkv); and the
# MoE FFNs: mixtral (swa, top-2 of 8 experts, so 8 arena rows overfill
# an expert's capacity of 4) and llama4 (attn, top-1 plus a shared expert);
# and the other engine-served dense archs: gemma3 (five 16-slot swa rings
# and a full cache), phi4-mini and llama3.
GRAPH_ARCHS = {"granite-3-2b": {}, "recurrentgemma-9b": {"n_layers": 5}, "rwkv6-1.6b": {},
               "mixtral-8x7b": {"n_experts": 8}, "llama4-maverick-400b-a17b": {},
               "gemma3-12b": {}, "phi4-mini-3.8b": {}, "llama3-405b": {},
               "granite-4.0-h-micro": {}}
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
    _decode_replay_matches_eager(cuda, _graph_engine(cuda, arch, dtype), arch)


def _decode_replay_matches_eager(cuda, eng, arch):
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
    eng.free_slots(arch, GSEQ, slots)


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


# ---------------------------------------------------------------------------
# prefill buckets as CUDA graphs
# ---------------------------------------------------------------------------
# Seq 16: wkv6's sequential design (below its 64-step chunk) and rglru's
# streaming route (one chunk); seq 72: wkv6's chunked design (bf16) and
# rglru's chunked route (5 chunks of 16).
PSEQS = (16, 72)


def _prefill_keys(arch, buckets=(1, 2, 4, 8)):
    return {("prefill", arch, s, b) for s in PSEQS for b in buckets}


def _prefill_replay_matches_eager(cuda, eng, arch, seq, b, rng):
    """The (seq, b) bucket's replay against its eager body on the same
    tokens, bit for bit: the served argmax, and the last position's
    logits through a step graph of ``last_logits`` captured the same way."""
    model, params = eng.models[arch], eng.params[arch]
    first, toks = (rng.integers(0, 256, size=(b, seq)).astype(np.int32) for _ in range(2))
    eng.dispatch(arch, (seq,), b, "prefill", payload=first).wait()  # eager, then captured
    got = eng.dispatch(arch, (seq,), b, "prefill", payload=toks).wait()
    dev_toks = torch.from_numpy(toks).to(cuda)
    (want,) = eng._prefill_fn(arch, seq, b)(dev_toks)

    def logits(t):
        with torch.no_grad():
            return (model.last_logits(params, t),)

    graph = _StepGraph(logits, (torch.from_numpy(first).to(cuda),), eng._graph_pool)
    (got_logits,) = graph.replay((dev_toks,))
    (want_logits,) = logits(dev_toks)
    torch.cuda.synchronize()
    assert got.shape == (b,) and torch.equal(got, want)
    assert torch.equal(got_logits, want_logits)
    assert torch.equal(want_logits.argmax(-1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_prefill_replay_matches_eager_body(cuda, arch, dtype):
    """Buckets 1 and 8 at both prefill seqs, every engine-served arch:
    a replay is the eager body's kernels in the same order, so bit for
    bit."""
    eng = _graph_engine(cuda, arch, dtype)
    rng = np.random.default_rng(7)
    for seq in PSEQS:
        for b in (1, 8):
            _prefill_replay_matches_eager(cuda, eng, arch, seq, b, rng)
    assert set(eng._graphs) == _prefill_keys(arch, buckets=(1, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_prefill_one_capture_per_bucket_and_none_later(cuda, arch):
    """The profiler's warm-up (every bucket twice) captures one graph per
    (mid, seq, bucket); afterwards every true batch 1-8 replays its
    bucket's graph, adds the launches its capture counted (the arch's
    prefill kernels among them) and hands out its own tokens."""
    eng = _graph_engine(cuda, arch, torch.bfloat16)
    for seq in PSEQS:
        eng.warmup(arch, (seq,), [1, 1, 2, 2, 3, 4, 5, 8, 8], "prefill")
    assert set(eng._graphs) == _prefill_keys(arch)
    assert eng.stats["prefill_compiles"] == len(_prefill_keys(arch))
    kinds = set(tiny(arch).block_pattern)
    for graph in eng._graphs.values():
        assert (graph.launches["flash_attention"] > 0) == bool(kinds & {"attn", "swa"})
        assert (graph.launches["wkv6"] > 0) == ("rwkv" in kinds)
        assert (graph.launches["rglru_scan"] > 0) == ("rglru" in kinds)
        assert graph.launches["decode_attention"] == 0
    eng.reset_stats()
    for seq in PSEQS:
        for b in range(1, 9):
            graph = eng._graphs[("prefill", arch, seq, bucket(b))]
            before = ops.launch_counts()
            out = eng.dispatch(arch, (seq,), b, "prefill").wait()
            assert {n: c - before[n] for n, c in ops.launch_counts().items()} == graph.launches
            assert out.shape == (bucket(b),) and out.data_ptr() != graph.outputs[0].data_ptr()
    assert eng.stats["prefill_compiles"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_back_to_back_prefill_replays_hold_their_own_tokens(cuda, arch):
    """Prefill replays enqueued back to back, waited on only at the end,
    each hold their own argmax, as a twin engine waiting after every call
    gives them."""
    a = _graph_engine(cuda, arch, torch.float32)
    b = _graph_engine(cuda, arch, torch.float32, params=a.params[arch])
    seq = PSEQS[1]
    for e in (a, b):
        e.warmup(arch, (seq,), [8, 8], "prefill")
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, size=(8, seq)).astype(np.int32) for _ in range(4)]
    handles = [a.dispatch(arch, (seq,), 8, "prefill", payload=p) for p in payloads]
    got = [h.wait() for h in handles]
    want = [b.dispatch(arch, (seq,), 8, "prefill", payload=p).wait() for p in payloads]
    assert len({g.data_ptr() for g in got}) == len(got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert any(not torch.equal(got[0], g) for g in got[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAPH_ARCHS))
def test_prefill_and_decode_graphs_share_one_pool(cuda, arch):
    """Prefill graphs captured between decode captures and replays, all in
    the engine's one pool: the decode step's replay still equals its eager
    step bit for bit (logits and every arena leaf), and so do prefill
    replays after decode replays; one graph per key."""
    eng = _graph_engine(cuda, arch, torch.bfloat16)
    _warm(eng, arch)
    rng = np.random.default_rng(13)
    for seq in PSEQS:
        for b in (1, 8):
            _prefill_replay_matches_eager(cuda, eng, arch, seq, b, rng)
    _decode_replay_matches_eager(cuda, eng, arch)
    for seq in PSEQS:
        _prefill_replay_matches_eager(cuda, eng, arch, seq, 8, rng)
    assert set(eng._graphs) == {("decode", arch, GSEQ)} | _prefill_keys(arch, buckets=(1, 8))
    assert eng.stats["decode_compiles"] == 1
    assert eng.stats["prefill_compiles"] == 4


@pytest.mark.cuda
def test_capture_survives_a_dead_graph_freed_meanwhile(cuda):
    """A graph that only a reference cycle keeps (here a dropped engine's)
    turns to garbage while another step is captured, with the collector
    set to run at every allocation and the process's older objects frozen
    out of its way, so that a collection would reach the dead graph then:
    the capture still succeeds, because the collector is off while
    capturing (and back on after), and its replay equals the eager
    body."""
    arch = "granite-3-2b"
    eng = _graph_engine(cuda, arch, torch.bfloat16)
    body = eng._prefill_fn(arch, PSEQS[0], 8)
    toks = torch.randint(0, 256, (8, PSEQS[0]), dtype=torch.int32, device=cuda)
    collecting = []

    def dropping(tokens):
        collecting.append(gc.isenabled())
        held.clear()  # the dead graph is now cyclic garbage
        _ = [[] for _ in range(100_000)]  # allocations: a collection would run here
        return body(tokens)

    gc.collect()
    gc.freeze()
    threshold = gc.get_threshold()
    try:
        dead = _graph_engine(cuda, arch, torch.bfloat16, params=eng.params[arch])
        dead.execute(arch, (PSEQS[0],), 1, "prefill")
        held = [dead._graphs[("prefill", arch, PSEQS[0], 1)]]
        held[0].cycle = held[0]
        del dead
        gc.set_threshold(1, 1, 1)
        graph = _StepGraph(dropping, (toks,), eng._graph_pool)
    finally:
        gc.set_threshold(*threshold)
        gc.unfreeze()
    assert gc.isenabled()
    gc.collect()
    (got,) = graph.replay((toks,))
    (want,) = body(toks)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert collecting == [False]


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_moe_zero_router_ties_and_dispatch_on_card(cuda, top_k):
    """A zero router makes every probability 1/E: the card takes experts
    0..k-1 as the CPU (and jax.lax.top_k) does. The MoE FFN on the card
    against the same call on the CPU, float32, at a capacity that drops
    tokens, with identical keep/slot decisions."""
    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(top_k)
    d, f, e = 32, 48, 8
    p = {"router": torch.randn(d, e, generator=gen) * 3.0,
         "gate": torch.randn(e, d, f, generator=gen) / d ** 0.5,
         "up": torch.randn(e, d, f, generator=gen) / d ** 0.5,
         "down": torch.randn(e, f, d, generator=gen) / f ** 0.5}
    x = torch.randn(3, 16, d, generator=gen) + torch.randn(d, generator=gen)
    pc = {k: v.to(cuda) for k, v in p.items()}
    plan_cpu = moe.dispatch_plan(p["router"], x.reshape(-1, d), top_k=top_k)
    plan_gpu = moe.dispatch_plan(pc["router"], x.reshape(-1, d).to(cuda), top_k=top_k)
    for name in ("top_e", "keep", "slot"):
        assert torch.equal(getattr(plan_gpu, name).cpu(), getattr(plan_cpu, name))
    assert bool((~plan_cpu.keep).any())
    want, aux = moe.apply_moe(p, x, top_k=top_k, activation="swiglu")
    got, aux_g = moe.apply_moe(pc, x.to(cuda), top_k=top_k, activation="swiglu")
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(aux_g.cpu(), aux, atol=1e-6, rtol=1e-6)
    pc["router"].zero_()
    zero = moe.dispatch_plan(pc["router"], x.reshape(-1, d).to(cuda), top_k=top_k)
    assert (zero.top_e.cpu() == torch.arange(top_k)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-maverick-400b-a17b"])
def test_moe_engine_kernel_path_matches_dense_on_card(cuda, arch):
    """Tiny MoE models in the engine on the card: prefill tokens and arena
    decode logits on the kernel path against impl="dense" on the same
    parameters, both attention kernels launched."""
    cfg = tiny(arch)
    eng = InferenceEngine({arch: cfg}, max_slots=4, device=cuda)
    dense = InferenceEngine({arch: dataclasses.replace(cfg, impl="dense")},
                            max_slots=4, device=cuda, params=eng.params)
    toks = np.random.default_rng(2).integers(0, 256, size=(3, 24)).astype(np.int32)
    before = ops.launch_counts()
    a = eng.dispatch(arch, (16,), 3, "prefill", payload=toks[:, :16]).wait()
    b = dense.dispatch(arch, (16,), 3, "prefill", payload=toks[:, :16]).wait()
    assert torch.equal(a[:3], b[:3])
    slots = eng.alloc_slots(arch, 32, 3)
    assert dense.alloc_slots(arch, 32, 3) == slots
    for step in range(20):
        payload = {s: int(t) for s, t in zip(slots, toks[:, step])}
        la = eng.dispatch(arch, (32,), 3, "decode", slots=slots, payload=payload).wait()
        lb = dense.dispatch(arch, (32,), 3, "decode", slots=slots, payload=payload).wait()
        torch.testing.assert_close(la[:3], lb[:3], atol=2e-3, rtol=2e-3)
    used = {n: ops.launch_counts()[n] - before[n] for n in before}
    assert used["decode_attention"] > 0 and used["flash_attention"] > 0


# ---------------------------------------------------------------------------
# the generalised attention kernels: cross-attention, position-valued
# masks, causal=False decode (whisper, qwen2-vl)
# ---------------------------------------------------------------------------


def _temporal_positions(cuda, b, s, gen):
    """A Qwen2-VL temporal stream per row: text, an image whose tokens
    share one position, then text; non-decreasing, starting at 0."""
    rows = []
    for _ in range(b):
        n = int(torch.randint(1, max(2, s // 2), (1,), generator=gen))
        p = int(torch.randint(0, s - n + 1, (1,), generator=gen))
        g = int(torch.randint(1, 8, (1,), generator=gen))
        row = torch.cat([torch.arange(p), torch.full((n,), p),
                         p + g + torch.arange(s - p - n)])
        rows.append(row)
    return torch.stack(rows).to(torch.int32).to(cuda)


# (B, S, S_kv, H, KV, D, causal, window, positions)
GEN_FLASH_CASES = [
    (2, 33, 150, 4, 4, 64, False, None, False),
    (1, 100, 1437, 20, 20, 64, False, None, False),
    (2, 1, 509, 8, 2, 128, False, None, False),
    (3, 200, 64, 8, 8, 32, False, None, False),
    (2, 300, 300, 8, 2, 128, True, None, True),
    (2, 509, 509, 16, 4, 64, True, 40, True),
    (1, 64, 64, 4, 4, 256, True, None, True),
    (2, 130, 130, 4, 1, 16, False, 9, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GEN_FLASH_CASES,
                         ids=lambda c: "B{}-S{}-Skv{}-H{}-KV{}-D{}-c{}-w{}-pos{}".format(*c))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_generalised_on_card(cuda, dtype, case):
    """Flash attention with S_kv != S (non-causal) and with position-valued
    masks against the plain version, bit-identical on a repeat, one launch
    counted per call; arange positions read like none."""
    b, s, skv, h, kv, d, causal, window, with_pos = case
    gen = torch.Generator(device=cuda).manual_seed(s + skv + d)
    q = torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, skv, kv, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, skv, kv, d), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window)
    if with_pos:
        pos = _temporal_positions(cuda, b, s, torch.Generator().manual_seed(s))
        kw.update(q_pos=pos, kv_pos=pos)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == before + 2
    assert torch.equal(got, again)
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    if with_pos:
        ar = torch.arange(s, dtype=torch.int32, device=cuda).expand(b, s).contiguous()
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, causal=causal, window=window, q_pos=ar, kv_pos=ar).float(),
            ops.flash_attention(q, k, v, causal=causal, window=window).float(),
            atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1500, 20, 1, 64), (3, 63, 2, 4, 16), (2, 448, 8, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_causal_false_on_card(cuda, dtype, shape):
    """Decode with causal=False (cross-attention: every valid slot attends
    whatever the cursor) against the plain version and the split twin, a
    dead row exact 0; whisper's group of 1 (H = KV = 20, D = 64) first."""
    b, s, kv, g, d = shape
    gen = torch.Generator(device=cuda).manual_seed(s + g)
    q = torch.randn((b, 1, kv * g, d), generator=gen, device=cuda).to(dtype)
    ck = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(dtype)
    cv = torch.randn((b, s, kv, d), generator=gen, device=cuda).to(dtype)
    cursor = torch.zeros(b, dtype=torch.int32, device=cuda)
    pos = torch.arange(s, dtype=torch.int32, device=cuda).expand(b, s).contiguous()
    active = torch.ones(b, dtype=torch.bool, device=cuda)
    active[-1] = False
    valid = (torch.rand((b, s), generator=gen, device=cuda) > 0.1) & active[:, None]
    args = (q, ck, cv, cursor, pos, valid.contiguous(), active)
    got = ops.decode_attention(*args, causal=False)
    assert torch.equal(got, ops.decode_attention(*args, causal=False))
    want = decode_attention_plain(*args, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    n_split = plan_splits(b, kv, s, torch.cuda.get_device_properties(cuda).multi_processor_count)[0]
    twin = decode_attention_split_plain(*args, causal=False, n_split=n_split)
    torch.testing.assert_close(got.float(), twin.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert float(got[-1].float().abs().max()) == 0.0
    causal = ops.decode_attention(*args)
    assert float((causal[:-1].float() - got[:-1].float()).abs().max()) > 0.1


@pytest.mark.cuda
def test_encdec_kernel_path_matches_dense_on_card(cuda):
    """Tiny whisper on the card, float32: forward and encode_for_decode +
    decode (a dead row) on the kernel path against impl="dense", both
    attention kernels launched."""
    from repro_torch.models import model_for

    cfg = tiny("whisper-large-v3")
    m_k = model_for(cfg)
    m_d = model_for(dataclasses.replace(cfg, impl="dense"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = m_k.init(gen, device=cuda)
    frames = 0.1 * torch.randn((2, 40, cfg.d_model), generator=gen, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen, device=cuda)
    active = torch.tensor([True, False], device=cuda)
    before = ops.launch_counts()
    lk, _ = m_k.forward(params, frames, toks)
    ld, _ = m_d.forward(params, frames, toks)
    torch.testing.assert_close(lk, ld, atol=2e-3, rtol=2e-3)
    outs = []
    for m in (m_k, m_d):
        cache = m.encode_for_decode(params, frames, m.init_cache(2, 24, 40, device=cuda))
        outs.append(torch.stack([m.decode_step(
            params, cache, toks[:, t], torch.full((2,), t, dtype=torch.int32, device=cuda),
            active=active)[0] for t in range(24)], 1))
    torch.testing.assert_close(outs[0][:1], outs[1][:1], atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(outs[0][:1], lk[:1], atol=2e-3, rtol=2e-3)
    used = {n: ops.launch_counts()[n] - before[n] for n in before}
    assert used["flash_attention"] == 2 * cfg.n_encoder_layers + 2 * cfg.n_layers
    assert used["decode_attention"] == 2 * 24 * cfg.n_layers


@pytest.mark.cuda
def test_mrope_kernel_path_matches_dense_on_card(cuda):
    """Tiny qwen2-vl on the card, float32: forward on Qwen2-VL positions
    and prefill + decode at the default mrope_position, the kernel path
    against impl="dense"."""
    from repro_torch.models import model_for

    cfg = tiny("qwen2-vl-72b")
    m_k = model_for(cfg)
    m_d = model_for(dataclasses.replace(cfg, impl="dense"))
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = m_k.init(gen, device=cuda)
    b, s = 2, 96
    toks = torch.randint(0, cfg.vocab_size, (b, s + 6), generator=gen, device=cuda)
    t = _temporal_positions(cuda, b, s, torch.Generator().manual_seed(2))
    pos = torch.stack([t, t + 1, t + 2])  # three streams; the mask reads the first
    lk, _ = m_k.forward(params, toks[:, :s], pos)
    ld, _ = m_d.forward(params, toks[:, :s], pos)
    torch.testing.assert_close(lk, ld, atol=2e-3, rtol=2e-3)
    outs = []
    for m in (m_k, m_d):
        cache = m.init_cache(b, s + 6, device=cuda)
        steps = [m.prefill(params, cache, toks[:, :s], pos)[0]]
        for i in range(6):
            cur = torch.full((b,), s + i, dtype=torch.int32, device=cuda)
            steps.append(m.decode_step(params, cache, toks[:, s + i], cur)[0])
        outs.append(torch.stack(steps))
    torch.testing.assert_close(outs[0], outs[1], atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_checkpoint_restores_onto_card(cuda, tmp_path):
    """bf16 parameters on the card through an async save and a restore onto
    the card: every leaf torch.equal, on the card, in bf16."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager, leaf_paths
    from repro_torch.models import model_for

    cfg = tiny("whisper-large-v3", param_dtype="bfloat16")
    params = model_for(cfg).init(torch.Generator(device=cuda).manual_seed(3), device=cuda)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params)
    mgr.wait()
    out = mgr.restore(1, params, device=cuda)
    for (na, a), (nb, b) in zip(leaf_paths(params), leaf_paths(out)):
        assert na == nb and b.device == a.device and b.dtype == torch.bfloat16
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# training: the flash backward kernel, gradients through the kernels, and
# the kernels without a backward refusing a gradient
# ---------------------------------------------------------------------------

# (B, S, S_kv, H, KV, D, causal, window, positions)
BWD_CASES = [
    (2, 100, 100, 8, 2, 64, True, None, False),
    (1, 130, 130, 4, 4, 32, True, None, False),
    (2, 509, 509, 16, 4, 64, True, 40, False),
    (2, 70, 70, 4, 1, 16, True, 9, False),
    (2, 33, 150, 4, 4, 64, False, None, False),
    (1, 100, 1437, 20, 20, 64, False, None, False),
    (2, 300, 300, 8, 2, 128, True, None, True),
    (2, 130, 130, 4, 1, 16, False, 9, True),
    (1, 64, 64, 4, 4, 256, True, None, False),
    # ragged S at the wgmma route's 128-query and 64-key block edges
    (2, 129, 129, 8, 2, 64, True, None, False),
    (2, 255, 255, 8, 2, 64, True, None, False),
    (2, 200, 200, 8, 2, 96, True, None, False),  # D zero-padded inside a 128 block
    (1, 257, 257, 64, 8, 64, True, None, True),  # group 8, positions
]


def _bwd_inputs(cuda, dtype, case):
    b, s, skv, h, kv, d, causal, window, with_pos = case
    gen = torch.Generator(device=cuda).manual_seed(s + skv + d + h)
    q, do = (torch.randn((b, s, h, d), generator=gen, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, skv, kv, d), generator=gen, device=cuda).to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window)
    if with_pos:
        pos = _temporal_positions(cuda, b, s, torch.Generator().manual_seed(s))
        kw.update(q_pos=pos, kv_pos=pos)
    return q, k, v, do, kw


# The float32 backward takes D <= 128 (shared memory): its D = 256 case
# runs in bf16 only.
BWD_DTYPE_CASES = [(dtype, case) for dtype in (torch.float32, torch.bfloat16)
                   for case in BWD_CASES if dtype == torch.bfloat16 or case[5] <= 128]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,case", BWD_DTYPE_CASES, ids=[
    "{}-B{}-S{}-Skv{}-H{}-KV{}-D{}-c{}-w{}-pos{}".format(str(d).split(".")[-1], *c)
    for d, c in BWD_DTYPE_CASES])
def test_flash_backward_kernel_on_card(cuda, dtype, case):
    """The forward's log-sum-exp against the plain one; the backward kernel
    (dQ, dK, dV) and its previous design against ``flash_attention_bwd_plain``
    on the kernel's own O and LSE, for every mask mode and GQA group; two
    calls of each torch.equal."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels.ref import flash_attention_fwd_lse_plain

    q, k, v, do, kw = _bwd_inputs(cuda, dtype, case)
    out, lse = fk.flash_attention_lse(q, k, v, **kw)
    out_p, lse_p = flash_attention_fwd_lse_plain(q, k, v, **kw)
    torch.testing.assert_close(out.float(), out_p.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, lse_p, atol=TOL[dtype], rtol=TOL[dtype])
    before = ops.launch_counts()["flash_attention_bwd"]
    got = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 2
    prev = fb.previous_design(q, k, v, out, do, lse, **kw)
    prev_again = fb.previous_design(q, k, v, out, do, lse, **kw)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 2
    want = fb.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    for design, first, second in (("kernel", got, again), ("previous", prev, prev_again)):
        for name, g, a, w in zip(("dq", "dk", "dv"), first, second, want):
            label = f"{design} {name}"
            assert g.dtype == dtype and g.shape == w.shape, label
            assert torch.equal(g, a), f"{label}: two calls differ"
            torch.testing.assert_close(g.float(), w.float(), atol=TOL[dtype], rtol=TOL[dtype],
                                       msg=lambda m, n=label: f"{n}: {m}")


@pytest.mark.cuda
def test_flash_backward_routes_on_card(cuda):
    """Each (dtype, D) takes the route the kernel's header states, by the
    built library's own dispatch: bf16 D <= 128 wgmma, bf16 D > 128
    the wide wgmma route, float32 FMA (D <= 128); the rest refused by
    both."""
    from repro_torch.kernels import flash_attention_bwd as fb

    want = {torch.bfloat16: lambda d: "wgmma" if d <= 128 else "wgmma_wide",
            torch.float32: lambda d: "fma"}
    for dtype, rule in want.items():
        for d in (8, 16, 32, 64, 96, 128, 136, 192, 256):
            if dtype == torch.float32 and d > 128:
                for fn in (fb.route, fb.kernel_route):
                    with pytest.raises(ValueError):
                        fn(dtype, d)
                continue
            assert fb.route(dtype, d) == fb.kernel_route(dtype, d) == rule(d), (dtype, d)
        for d in (12, 264):
            for fn in (fb.route, fb.kernel_route):
                with pytest.raises(ValueError):
                    fn(dtype, d)


# (B, S, H, KV, D, window, positions): recurrentgemma-9b's MQA layout
# and gemma3-12b's GQA one at D = 256, small S; ragged S, D = 136 (padded
# to 256), positions.
WIDE_CASES = [(1, 320, 16, 1, 256, 100, False), (1, 256, 16, 8, 256, 128, False),
              (2, 201, 4, 1, 136, 70, False), (1, 130, 8, 2, 256, None, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: "B{}-S{}-H{}-KV{}-D{}-w{}-pos{}".format(*c))
def test_flash_backward_wide_route_on_card(cuda, case):
    """bf16 at 128 < D <= 256: the wide route against the plain backward
    at 2e-2, two calls torch.equal, its parts the rule's for the card, and
    no kernel of the first design launched (the profiler's kernel names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels.ref import flash_bwd_head_parts

    b, s, h, kv, d, window, with_pos = case
    q, k, v, do, kw = _bwd_inputs(cuda, torch.bfloat16, (b, s, s, h, kv, d, True, window,
                                                         with_pos))
    out, lse = fk.flash_attention_lse(q, k, v, **kw)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    parts = fb.head_parts(b, s, h, kv, d, torch.bfloat16, cuda)
    assert parts == flash_bwd_head_parts(b, s, kv, h // kv, sms)
    assert fb.route(torch.bfloat16, d) == fb.kernel_route(torch.bfloat16, d) == "wgmma_wide"
    before = ops.launch_counts()["flash_attention_bwd"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
    again = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert ops.launch_counts()["flash_attention_bwd"] == before + 2
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert any("dkdv_wide_wgmma_kernel" in n for n in names), names
    assert any("dq_wide_wgmma_kernel" in n for n in names), names
    assert not any("dkdv_kernel<" in n or "dq_kernel<" in n for n in names), names
    assert any("dkdv_reduce_kernel" in n for n in names) == (parts > 1), names
    want = fb.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g, a), f"{name}: two calls differ"
        torch.testing.assert_close(g.float(), w.float(), atol=TOL[torch.bfloat16],
                                   rtol=TOL[torch.bfloat16], msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_through_kernels_on_card(cuda, dtype):
    """ops.flash_attention under autograd: FlashAttentionFn's gradients
    against autograd through the plain version, one forward and one
    backward launch counted."""
    q, k, v, do, kw = _bwd_inputs(cuda, dtype, (2, 200, 200, 8, 2, 64, True, 50, False))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = ops.launch_counts()
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 1
    assert after["flash_attention_bwd"] - before["flash_attention_bwd"] == 1
    plain = [t.float().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*plain, **kw), plain, do.float())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_serving_flash_call_writes_no_lse_and_keeps_no_graph(cuda, monkeypatch):
    """Without a gradient (no_grad, or inputs that need none) the flash call
    is the serving path's: no log-sum-exp written, no autograd graph."""
    from repro_torch.kernels import flash_attention as fk

    seen = []
    real = fk._launch

    def spy(*args, **kw):
        seen.append(kw.get("with_lse", False))
        return real(*args, **kw)

    monkeypatch.setattr(fk, "_launch", spy)
    q, k, v, _, kw = _bwd_inputs(cuda, torch.bfloat16, (2, 64, 64, 4, 2, 64, True, None, False))
    out = ops.flash_attention(q, k, v, **kw)
    assert out.grad_fn is None
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v, **kw)
    assert out.grad_fn is None and seen == [False, False]
    out = ops.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None and seen[-1] is True


@pytest.mark.cuda
def test_kernels_without_backward_refuse_a_gradient_on_card(cuda):
    """decode_attention, the one kernel without a backward, raises on the
    card when a gradient is required of it, naming the kernel; under
    no_grad it runs. wkv6 and rglru_scan now give gradients (their
    backward kernels), and wkv6 refuses its in-place state_out then."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    qd = torch.randn((2, 1, 4, 64), generator=gen, device=cuda, requires_grad=True)
    ck = torch.randn((2, 64, 2, 64), generator=gen, device=cuda)
    cur = torch.tensor([63, 10], dtype=torch.int32, device=cuda)
    pos = torch.arange(64, dtype=torch.int32, device=cuda).expand(2, 64).contiguous()
    valid = pos <= cur[:, None]
    with pytest.raises(RuntimeError, match="decode_attention"):
        ops.decode_attention(qd, ck, ck, cur, pos, valid)
    with torch.no_grad():
        ops.decode_attention(qd, ck, ck, cur, pos, valid)
    r = torch.randn((1, 8, 2, 64), generator=gen, device=cuda, requires_grad=True)
    w = torch.rand((1, 8, 2, 64), generator=gen, device=cuda) * 0.5 + 0.4
    u = torch.randn((2, 64), generator=gen, device=cuda)
    before = ops.launch_counts()
    out, _ = ops.wkv6(r, r.detach(), r.detach(), w, u)
    (gr,) = torch.autograd.grad(out.sum(), [r])
    assert torch.isfinite(gr).all()
    with pytest.raises(ValueError, match="state_out"):
        buf = torch.zeros((1, 2, 64, 64), device=cuda)
        ops.wkv6(r, r.detach(), r.detach(), w, u, buf, state_out=buf)
    a = torch.rand((1, 8, 32), generator=gen, device=cuda)
    bb = torch.randn((1, 8, 32), generator=gen, device=cuda, requires_grad=True)
    hs, _ = ops.rglru_scan(a, bb)
    (gb,) = torch.autograd.grad(hs.sum(), [bb])
    assert torch.isfinite(gb).all()
    after = ops.launch_counts()
    assert after["wkv6_bwd"] - before["wkv6_bwd"] == 1
    assert after["rglru_bwd"] - before["rglru_bwd"] == 1
    with torch.no_grad():
        ops.wkv6(r, r, r, w, u)
        ops.rglru_scan(a, bb)


WKV_BWD_CASES = [(1, 1, 2, 16, False), (2, 37, 2, 16, True), (2, 130, 4, 64, True),
                 (1, 509, 2, 64, False), (2, 64, 3, 24, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_BWD_CASES, ids=lambda c: "B{}-S{}-H{}-K{}-state{}".format(*c))
@pytest.mark.parametrize("dtype,w_dtype", WKV_PAIRS)
def test_wkv6_backward_kernel_on_card(cuda, case, dtype, w_dtype):
    """The backward kernel against autograd through the plain forward
    (``wkv6_ref``) with cotangents on o and the last state: float32 at
    2e-5, bf16 at 2e-2; S ragged against the kernel's 16-step tiles and
    4-step sub-blocks, K = V < 64; two calls torch.equal."""
    from repro_torch.kernels import wkv6_bwd as wb
    from repro_torch.kernels.ref import wkv6_ref

    b, s, h, k, with_state = case
    r, kk, v, w, u, state = _wkv_inputs(cuda, b, s, h, k, dtype, w_dtype, seed=s + k)
    state = state if with_state else None
    g = torch.Generator(device=cuda).manual_seed(3 * s)
    do = torch.randn((b, s, h, k), generator=g, device=cuda).to(dtype)
    ds = torch.randn((b, h, k, k), generator=g, device=cuda)
    ins = [r, kk, v, w, u] + ([state] if with_state else [])
    leaves = [x.clone().requires_grad_() for x in ins]
    out, last = wkv6_ref(*leaves[:5], leaves[5] if with_state else None)
    want = torch.autograd.grad((out.float() * do.float()).sum() + (last * ds).sum(), leaves)
    before = ops.launch_counts()["wkv6_bwd"]
    got = wb.wkv6_bwd(r, kk, v, w, u, do, state, ds)
    again = wb.wkv6_bwd(r, kk, v, w, u, do, state, ds)
    assert ops.launch_counts()["wkv6_bwd"] == before + 2
    tol = TOL[dtype]
    for name, gt, ag, wt in zip(("dr", "dk", "dv", "dw", "du", "d_state0"), got, again, want):
        assert gt.dtype == wt.dtype and torch.equal(gt, ag), name
        assert torch.isfinite(gt.float()).all(), name
        torch.testing.assert_close(gt.float(), wt.float(), atol=tol, rtol=tol, msg=name)
    assert (got[5] is None) == (not with_state)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [77, 200])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_backward_chunked_design_on_card(cuda, s, w_dtype, with_state):
    """bf16 r takes the chunked design: against the plain backward
    (``wkv6_bwd_plain``) and the sequential design (``previous_design``)
    at 2e-2, S ragged against the 64-step chunks and 16-step tiles, two
    calls torch.equal; float32 r keeps the sequential design."""
    from repro_torch.kernels import wkv6_bwd as wb
    from repro_torch.kernels.ref import wkv6_bwd_plain

    assert wb.design(torch.bfloat16) == "chunked" and wb.design(torch.float32) == "sequential"
    b, h, k = 2, 3, 64
    r, kk, v, w, u, state = _wkv_inputs(cuda, b, s, h, k, torch.bfloat16, w_dtype, seed=7 * s)
    state = state if with_state else None
    g = torch.Generator(device=cuda).manual_seed(s)
    do = torch.randn((b, s, h, k), generator=g, device=cuda).to(torch.bfloat16)
    ds = torch.randn((b, h, k, k), generator=g, device=cuda)
    args = (r, kk, v, w, u, do, state, ds)
    got, again = wb.wkv6_bwd(*args), wb.wkv6_bwd(*args)
    prev = wb.previous_design(*args)
    want = wkv6_bwd_plain(*args)
    tol = TOL[torch.bfloat16]
    for name, gt, ag, pv, wt in zip(("dr", "dk", "dv", "dw", "du", "d_state0"), got, again,
                                    prev, want):
        if name == "d_state0" and not with_state:
            assert gt is None and pv is None
            continue
        assert gt.dtype == pv.dtype and torch.equal(gt, ag), name
        for label, x in (("plain", wt), ("sequential", pv)):
            torch.testing.assert_close(gt.float(), x.float(), atol=tol, rtol=tol,
                                       msg=lambda m, n=f"{name} vs {label}": f"{n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 16), (2, 37, 48), (1, 256, 128), (3, 509, 520),
                                   (8, 512, 4096), (1, 4096, 4096), (2, 1000, 520)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_backward_kernel_on_card(cuda, shape, dtype, with_h0):
    """The backward kernel against autograd through the plain forward
    (``rglru_ref``), cotangents on h and the last h: float32 at 2e-5, bf16
    at 2e-2 (the kernel reads h_{t-1} from the bf16 output); float32 is
    bit for bit its route's plain backward (``rglru_bwd_plain`` streaming,
    ``rglru_bwd_chunked_plain`` chunked, which is also held at 2e-5 to the
    sequential one); two calls torch.equal."""
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels import rglru_bwd as rb
    from repro_torch.kernels.ref import rglru_bwd_chunked_plain

    b, s, d = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + with_h0)
    a = (torch.sigmoid(torch.randn(shape, generator=g, device=cuda)) * 0.5 + 0.45).to(dtype)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    h0 = torch.randn((b, d), generator=g, device=cuda) if with_h0 else None
    dh = torch.randn(shape, generator=g, device=cuda).to(dtype)
    dlast = torch.randn((b, d), generator=g, device=cuda)
    leaves = [a.clone().requires_grad_(), x.clone().requires_grad_()]
    leaves += [h0.clone().requires_grad_()] if with_h0 else []
    hs, last = rglru_scan_plain(*leaves)
    want = torch.autograd.grad((hs.float() * dh.float()).sum() + (last * dlast).sum(), leaves)
    h, _ = ops.rglru_scan(a, x, h0)
    got = rb.rglru_bwd(a, h, dh, dlast, h0)
    again = rb.rglru_bwd(a, h, dh, dlast, h0)
    tol = TOL[dtype]
    for name, gt, ag, wt in zip(("da", "db", "dh0"), got, again, want):
        assert gt.dtype == wt.dtype and torch.equal(gt, ag), name
        torch.testing.assert_close(gt.float(), wt.float(), atol=tol, rtol=tol, msg=name)
    plan = rk.route(a)
    if plan is not None:
        seq = rb.rglru_bwd_plain(a, h, dh, dlast, h0)
        for name, gt, sq in zip(("da", "db", "dh0"), got, seq):
            torch.testing.assert_close(gt.float(), sq.float(), atol=tol, rtol=tol, msg=name)
    if dtype == torch.float32:
        plain = (rb.rglru_bwd_plain(a, h, dh, dlast, h0) if plan is None
                 else rglru_bwd_chunked_plain(a, h, dh, dlast, h0, chunk=plan[0]))
        assert all(torch.equal(gt, pt) for gt, pt in zip(got, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 64, 200])
def test_recurrences_unchanged_under_no_grad_on_card(cuda, s):
    """Under no_grad ops.wkv6 and ops.rglru_scan make the serving call: no
    graph, no backward launch, and outputs bit for bit those of the same
    kernels taken through their autograd Functions."""
    r, kk, v, w, u, state = _wkv_inputs(cuda, 2, s, 4, 64, torch.bfloat16, torch.float32, 9)
    g = torch.Generator(device=cuda).manual_seed(s)
    a = torch.sigmoid(torch.randn((2, s, 96), generator=g, device=cuda))
    x = torch.randn((2, s, 96), generator=g, device=cuda)
    before = ops.launch_counts()
    with torch.no_grad():
        o1, l1 = ops.wkv6(r.requires_grad_(), kk, v, w, u, state)
        h1, hl1 = ops.rglru_scan(a, x.requires_grad_(), None)
    assert o1.grad_fn is None and h1.grad_fn is None
    o2, l2 = ops.wkv6(r, kk, v, w, u, state)
    h2, hl2 = ops.rglru_scan(a, x, None)
    assert o2.grad_fn is not None and h2.grad_fn is not None
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    assert torch.equal(h1, h2) and torch.equal(hl1, hl2)
    after = ops.launch_counts()
    assert after["wkv6"] - before["wkv6"] == 2 and after["rglru_scan"] - before["rglru_scan"] == 2
    assert after["wkv6_bwd"] == before["wkv6_bwd"] and after["rglru_bwd"] == before["rglru_bwd"]


# Gradient tolerance of each leaf's max abs. tiny rwkv6's float32
# gradients pass through a per-head group norm of small outputs: on an
# H100 the dense path alone, on the card against the same dense path on the
# CPU, differs by up to 2.2e-4 of a leaf's max abs (the kernel path
# against dense on the card: 1.6e-4); recurrentgemma's by 2.2e-6 (8e-7).
RECURRENT_GRAD_TOL = {"rwkv6-1.6b": 5e-4, "recurrentgemma-9b": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_recurrent_train_step_through_kernels_matches_dense_on_card(cuda, arch, monkeypatch):
    """A tiny float32 recurrent model with remat on: the loss and every
    parameter leaf's gradient through the kernels (wkv6 / rglru_scan
    forward, their backward kernels, flash for recurrentgemma's local
    attention) against impl="dense" (``RECURRENT_GRAD_TOL`` of each leaf's
    max abs), both arms normalising through the row-norm kernel
    (``RownormFn``, whose backward differentiates the plain chain): these
    gradients move by more than the tolerance when only the norms'
    rounding moves, so the arms share their norms, as they shared the
    chain before the kernel. No other plain version runs in the kernel
    arm; two forwards (remat) and one backward per recurrence, two
    row-norm launches per block norm and one for the final norm; then a
    train step gives a finite loss."""
    from repro_torch.kernels import rglru as rk
    from repro_torch.kernels import rglru_bwd as rb
    from repro_torch.kernels import wkv6_bwd as wb
    from repro_torch.models import layers, model_for
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_loop as ttl

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((wk, "wkv6_plain"), (rk, "rglru_scan_plain"), (wb, "wkv6_bwd_plain"),
                      (rb, "rglru_bwd_plain")):
        monkeypatch.setattr(mod, name, refuse)
    cfg = tiny(arch, remat=True)
    gen = torch.Generator(device=cuda).manual_seed(13)
    mk, md = model_for(cfg), model_for(dataclasses.replace(cfg, impl="dense"))
    params = ttl.trainable(mk.init(gen, device=cuda))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 70), generator=gen, device=cuda)}
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    leaves = tree_leaves(params)
    before = ops.launch_counts()
    lk = mk.loss(params, batch["tokens"])
    gk = torch.autograd.grad(lk, leaves)
    after = ops.launch_counts()
    used = {n: after[n] - before[n] for n in after}
    n_rwkv, n_rglru, n_swa = (kinds.count(x) for x in ("rwkv", "rglru", "swa"))
    assert used == {"decode_attention": 0, "flash_attention": 2 * n_swa,
                    "flash_attention_bwd": n_swa, "wkv6": 2 * n_rwkv, "wkv6_bwd": n_rwkv,
                    "rglru_scan": 2 * n_rglru, "rglru_bwd": n_rglru,
                    "rownorm": 4 * cfg.n_layers + 1, "ssd_chunk": 0, "ssd_step": 0}
    rms, ln = layers.rmsnorm, layers.layernorm
    monkeypatch.setattr(layers, "rmsnorm", lambda x, w, eps=1e-6, impl="xla": rms(x, w, eps))
    monkeypatch.setattr(layers, "layernorm",
                        lambda x, w, b, eps=1e-5, impl="xla": ln(x, w, b, eps))
    ld = md.loss(params, batch["tokens"])
    gd = torch.autograd.grad(ld, leaves)
    monkeypatch.setattr(layers, "rmsnorm", rms)
    monkeypatch.setattr(layers, "layernorm", ln)
    torch.testing.assert_close(lk, ld, atol=1e-5, rtol=1e-5)
    for a, w in zip(gk, gd):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= RECURRENT_GRAD_TOL[arch] * max(scale, 1e-30)
    step = ttl.make_train_step(mk, ttl.TrainConfig(adamw=topt.AdamWConfig(warmup_steps=1)))
    state, met = step(ttl.TrainState(params, topt.init(params)), batch)
    assert bool(torch.isfinite(met["loss"])) and int(state.opt.step) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-vl-72b", "whisper-large-v3"])
def test_train_step_through_kernels_matches_dense_on_card(cuda, arch, monkeypatch):
    """A tiny float32 model with remat on: the loss and every parameter
    leaf's gradient through the kernels (flash forward with LSE, the
    backward kernel) against impl="dense" (autograd through plain PyTorch
    attention) at 1e-4 of each leaf's max abs; no plain version runs; two
    flash forwards (remat) and one backward per attention call; then a
    train step through the kernels gives a finite loss."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.models import model_for
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_loop as ttl

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(fk, "flash_attention_plain", refuse)
    monkeypatch.setattr(fb, "flash_attention_bwd_plain", refuse)
    cfg = tiny(arch, remat=True)
    gen = torch.Generator(device=cuda).manual_seed(11)
    mk, md = model_for(cfg), model_for(dataclasses.replace(cfg, impl="dense"))
    params = ttl.trainable(mk.init(gen, device=cuda))
    b, s = 2, 40
    if cfg.encdec:
        batch = {"frames": 0.1 * torch.randn((b, 30, cfg.d_model), generator=gen, device=cuda),
                 "dec_tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                             device=cuda)}
        loss = lambda m: m.loss(params, batch["frames"], batch["dec_tokens"])
        n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
        n_norm = 2 * (2 * cfg.n_encoder_layers + 3 * cfg.n_layers) + 2
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=cuda)}
        if cfg.rope_kind == "mrope":
            t = _temporal_positions(cuda, b, s, torch.Generator().manual_seed(2))
            batch["positions"] = torch.stack([t, t, t])
        loss = lambda m: m.loss(params, batch["tokens"], batch.get("positions"))
        n_attn = cfg.n_layers
        n_norm = 4 * cfg.n_layers + 1
    leaves = tree_leaves(params)
    before = ops.launch_counts()
    lk = loss(mk)
    gk = torch.autograd.grad(lk, leaves)
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 2 * n_attn
    assert after["flash_attention_bwd"] - before["flash_attention_bwd"] == n_attn
    assert after["rownorm"] - before["rownorm"] == n_norm
    assert all(after[n] == before[n] for n in ("decode_attention", "wkv6", "wkv6_bwd",
                                               "rglru_scan", "rglru_bwd"))
    ld = loss(md)
    gd = torch.autograd.grad(ld, leaves)
    torch.testing.assert_close(lk, ld, atol=1e-5, rtol=1e-5)
    for a, w in zip(gk, gd):
        scale = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-4 * max(scale, 1e-30)
    step = ttl.make_train_step(mk, ttl.TrainConfig(adamw=topt.AdamWConfig(warmup_steps=1)))
    state, met = step(ttl.TrainState(params, topt.init(params)), batch)
    assert bool(torch.isfinite(met["loss"])) and int(state.opt.step) == 1


@pytest.mark.cuda
def test_host_mesh_train_step_equals_unmeshed_on_card(cuda):
    """A tiny granite (bf16, remat on) on the (1, 1) NCCL host mesh: two
    train steps equal the unmeshed steps bit for bit (losses and every state
    leaf, deterministic algorithms on), with the same flash forward and
    backward launches a step."""
    import os

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import destroy_process_group, make_host_mesh
    from repro_torch.models import model_for
    from repro_torch.training import train_loop as ttl

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = tiny(MID, remat=True, param_dtype="bfloat16")
    model = model_for(cfg)
    gen = torch.Generator(device=cuda).manual_seed(5)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                                        device=cuda)} for _ in range(2)]
    mesh = make_host_mesh()

    def run(meshed):
        state = ttl.init_state(model, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        if meshed:
            state = ttl.place_state(state, ttl.shardings_for_state(model, mesh))
            shd.install_activation_resolver(mesh)
        step = ttl.make_train_step(model, ttl.TrainConfig())
        losses, launches = [], []
        try:
            for b in batches:
                before = ops.launch_counts()
                state, met = step(state, ttl.place_batch(b, mesh) if meshed else b)
                losses.append(float(met["loss"]))
                after = ops.launch_counts()
                launches.append({n: after[n] - before[n] for n in after})
        finally:
            shd.clear_activation_resolver()
        return losses, launches, [t.detach() for t in tree_leaves(list(ttl.full_state(state)))]

    torch.use_deterministic_algorithms(True)
    try:
        want = run(False)
        got = run(True)
    finally:
        torch.use_deterministic_algorithms(False)
        destroy_process_group()
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert all(l["flash_attention"] == 2 * cfg.n_layers and
               l["flash_attention_bwd"] == cfg.n_layers and
               l["rownorm"] == 4 * cfg.n_layers + 1 for l in got[1])
    assert len(got[2]) == len(want[2])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


@pytest.mark.cuda
def test_ops_on_a_dtensor_run_the_kernel_on_the_local_shard(cuda):
    """``ops.flash_attention`` on DTensors (host mesh) launches the kernel
    once, on the local shard, and returns a DTensor whose local tensor is
    the plain call's result; the gradient goes through the backward
    kernel."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import destroy_process_group, make_host_mesh

    mesh = make_host_mesh()
    try:
        g = torch.Generator(device=cuda).manual_seed(3)
        q, k, v = (torch.randn((2, 96, h, 64), generator=g, device=cuda).to(torch.bfloat16)
                   for h in (8, 2, 2))
        qd, kd, vd = (DTensor.from_local(t, mesh, [Shard(0), Replicate()], run_check=False)
                      .requires_grad_() for t in (q, k, v))
        before = ops.launch_counts()
        out = ops.flash_attention(qd, kd, vd, causal=True)
        out.sum().backward()
        after = ops.launch_counts()
        assert isinstance(out, DTensor) and tuple(out.placements) == (Shard(0), Replicate())
        assert after["flash_attention"] - before["flash_attention"] == 1
        assert after["flash_attention_bwd"] - before["flash_attention_bwd"] == 1
        want = ops.flash_attention(q, k, v, causal=True)
        assert torch.equal(out.to_local(), want)
        assert qd.grad is not None and tuple(qd.grad.placements) == (Shard(0), Replicate())
    finally:
        destroy_process_group()


# ---------------------------------------------------------------------------
# the row-norm kernel (RMS and layer norm)
# ---------------------------------------------------------------------------
# Rows: one, a ragged few, granite.chat's 32 decode rows, the 8 x 512
# prefill bucket and the 8 x 992 one; widths of the zoo, to llama3-405b's.
NORM_ROWS = (1, 3, 32, 4096, 7936)
NORM_DS = (2048, 3072, 4096, 5120, 16384)


def _norm_inputs(cuda, shape, dtype, w_dtype, center, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    d = shape[-1]
    x = (3 * torch.randn(shape, generator=g, device=cuda) + 0.5).to(dtype)
    w = (0.1 * torch.randn(d, generator=g, device=cuda) + (1.0 if center else 0.0)).to(w_dtype)
    b = (0.1 * torch.randn(d, generator=g, device=cuda)).to(w_dtype) if center else None
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("d", NORM_DS)
@pytest.mark.parametrize("center", [False, True], ids=["rms", "layer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rownorm_kernel_matches_plain_on_card(cuda, dtype, center, d):
    """The kernel against its plain twin at every row count, one launch a
    call, and two calls equal bit for bit."""
    eps = 1e-5 if center else 1e-6
    for rows in NORM_ROWS:
        x, w, b = _norm_inputs(cuda, (rows, d), dtype, dtype, center, rows + d)
        before = ops.launch_counts()["rownorm"]
        got = ops.rownorm(x, w, b, eps=eps, center=center)
        again = ops.rownorm(x, w, b, eps=eps, center=center)
        torch.cuda.synchronize()
        assert ops.launch_counts()["rownorm"] == before + 2
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got, again)
        want = rownorm_plain(x, w, b, eps=eps, center=center)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("center", [False, True], ids=["rms", "layer"])
@pytest.mark.parametrize("dtype,w_dtype", [(torch.bfloat16, torch.float32),
                                           (torch.float32, torch.bfloat16)])
def test_rownorm_mixed_weights_and_strided_rows_on_card(cuda, dtype, w_dtype, center):
    """Weights in the other dtype, and a batch's last position (rows one
    stride apart, as ``last_logits`` normalises them): the twin's values,
    and the strided rows' results equal to their contiguous copy's."""
    eps = 1e-5 if center else 1e-6
    x, w, b = _norm_inputs(cuda, (8, 72, 2048), dtype, w_dtype, center, 11)
    got = ops.rownorm(x, w, b, eps=eps, center=center)
    want = rownorm_plain(x, w, b, eps=eps, center=center)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    last = x[:, -1:]
    got_last = ops.rownorm(last, w, b, eps=eps, center=center)
    assert got_last.shape == last.shape and got_last.is_contiguous()
    assert torch.equal(got_last, ops.rownorm(last.contiguous(), w, b, eps=eps, center=center))
    assert torch.equal(got_last, got[:, -1:])


@pytest.mark.cuda
@pytest.mark.parametrize("center", [False, True], ids=["rms", "layer"])
@pytest.mark.parametrize("needs", ["w", "x+w+b"])
def test_rownorm_gradient_is_the_chains_on_card(cuda, center, needs):
    """An input that needs a gradient while autograd records: one launch
    (``RownormFn``), the twin's values, and for one upstream gradient the
    gradients of the inputs that need one equal bit for bit to autograd's
    through the plain chain;
    under ``no_grad`` the same call launches once more."""
    x, w, b = _norm_inputs(cuda, (16, 2048), torch.bfloat16, torch.bfloat16, center, 5)
    eps = 1e-5 if center else 1e-6
    leaves = [t for name, t in (("x", x), ("w", w), ("b", b)) if t is not None and name in needs]
    for t in leaves:
        t.requires_grad_(True)
    gy = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(6),
                     device=cuda).to(x.dtype)
    before = ops.launch_counts()
    got = ops.rownorm(x, w, b, eps=eps, center=center)
    grads = torch.autograd.grad(got, leaves, gy)
    assert ops.launch_counts() == dict(before, rownorm=before["rownorm"] + 1)
    want = rownorm_plain(x, w, b, eps=eps, center=center)
    wanted = torch.autograd.grad(want, leaves, gy)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
    assert all(torch.equal(g, e) for g, e in zip(grads, wanted))
    with torch.no_grad():
        ops.rownorm(x, w, b, eps=eps, center=center)
    assert ops.launch_counts()["rownorm"] == before["rownorm"] + 2


@pytest.mark.cuda
def test_rownorm_on_a_dtensor_runs_the_kernel_on_the_local_shard(cuda):
    """``ops.rownorm`` on DTensors (host mesh): one launch on the local
    shard, the rows' placement kept, the local result the plain call's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import destroy_process_group, make_host_mesh

    mesh = make_host_mesh()
    try:
        x, w, _ = _norm_inputs(cuda, (4, 64, 2048), torch.bfloat16, torch.bfloat16, False, 7)
        xd = DTensor.from_local(x, mesh, [Shard(0), Replicate()], run_check=False)
        before = ops.launch_counts()["rownorm"]
        out = ops.rownorm(xd, w, eps=1e-6, center=False)
        assert ops.launch_counts()["rownorm"] == before + 1
        assert isinstance(out, DTensor) and tuple(out.placements) == (Shard(0), Replicate())
        assert torch.equal(out.to_local(), ops.rownorm(x, w, eps=1e-6, center=False))
    finally:
        destroy_process_group()


# Published depths at tiny width: granite-3-2b's 40 layers, rwkv6-1.6b's 24.
NORM_DEPTHS = {"granite-3-2b": 40, "rwkv6-1.6b": 24}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(NORM_DEPTHS))
def test_norm_launches_per_replay_at_published_depth(cuda, arch):
    """At the published depth (bf16, tiny width) the 8 x 72 prefill
    bucket's replay, and granite's decode step's, equal their eager steps
    bit for bit and launch the row-norm kernel 2 L + 1 times: two norms a
    block and the final norm (81 for granite, 49 for rwkv6)."""
    n = NORM_DEPTHS[arch]
    cfg = dataclasses.replace(tiny(arch, n_layers=n), param_dtype="bfloat16")
    eng = InferenceEngine({arch: cfg}, max_slots=8, device=cuda)
    _prefill_replay_matches_eager(cuda, eng, arch, 72, 8, np.random.default_rng(3))
    assert eng._graphs[("prefill", arch, 72, 8)].launches["rownorm"] == 2 * n + 1
    if arch == "granite-3-2b":
        _decode_replay_matches_eager(cuda, eng, arch)
        assert eng._graphs[("decode", arch, GSEQ)].launches["rownorm"] == 2 * n + 1


# ---------------------------------------------------------------------------
# Mamba-2 (granite-4.0-h-micro): ssd_chunk, ssd_step, the gated row norm,
# and held arena rows of every recurrent kind
# ---------------------------------------------------------------------------

SSD_SIZES = [(4, 16, 16), (64, 64, 128)]  # (H, P, N): the tiny config's, the published


def _ssd_chunk_args(cuda, g, b, s, h, p, n, dtype):
    """xbc and dt as views of one input projection, as the model passes
    them, the conv's weights and the per-head parameters."""
    cc = h * p + 2 * n
    proj = torch.randn((b, s, cc + h + 8), generator=g, device=cuda).to(dtype)
    return (proj[..., :cc], (0.5 * torch.randn((4, cc), generator=g, device=cuda)).to(dtype),
            (0.1 * torch.randn(cc, generator=g, device=cuda)).to(dtype), proj[..., cc:cc + h],
            (torch.randn(h, generator=g, device=cuda) - 3.0).to(dtype),
            (0.5 * torch.randn(h, generator=g, device=cuda) + 1.0).to(dtype),
            (1.0 + 0.1 * torch.randn(h, generator=g, device=cuda)).to(dtype))


def _ssd_step_args(cuda, g, rows, h, p, n, dtype):
    cc = h * p + 2 * n
    proj = torch.randn((rows, cc + h + 8), generator=g, device=cuda).to(dtype)
    return (proj[:, :cc], proj[:, cc:cc + h], torch.randn((rows, 3, cc), generator=g, device=cuda),
            (0.5 * torch.randn((4, cc), generator=g, device=cuda)).to(dtype),
            (0.1 * torch.randn(cc, generator=g, device=cuda)).to(dtype),
            (torch.randn(h, generator=g, device=cuda) - 3.0).to(dtype),
            (0.5 * torch.randn(h, generator=g, device=cuda) + 1.0).to(dtype),
            (1.0 + 0.1 * torch.randn(h, generator=g, device=cuda)).to(dtype),
            torch.randn((rows, h, p, n), generator=g, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("size", SSD_SIZES + [(2, 24, 12)], ids=["tiny", "published", "narrow"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_matches_its_twin(cuda, dtype, s, size):
    """ssd_chunk against its twin ref.ssd_chunk_plain (the conv and SiLU,
    then the chunked recurrence; y and the last state), on strided views
    as the model passes them, ragged chunks included; float32 also against
    the conv then the step-by-step ref.ssd_ref; two calls equal. "narrow"
    (N 12) stages bf16 rows element by element, the others by 16-byte
    vectors."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as sc

    g = torch.Generator(device=cuda).manual_seed(s)
    h, p, n = size
    args = _ssd_chunk_args(cuda, g, 2, s, h, p, n, dtype)
    before = ops.launch_counts()
    y, last = ops.ssd_chunk(*args, state_size=n)
    assert ops.launch_counts()["ssd_chunk"] == before["ssd_chunk"] + 1
    want, want_last = ref.ssd_chunk_plain(*args, state_size=n)
    torch.testing.assert_close(y.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(last, want_last, atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == torch.float32:
        xbc, w, bias, dt, dt_bias, a_log, d = args
        x, bm, cm = ref.ssd_conv(xbc, w, bias, h, n)
        seq_y, seq_last = ref.ssd_ref(x, dt, dt_bias, a_log, bm, cm, d)
        torch.testing.assert_close(y, seq_y, atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(last, seq_last, atol=TOL[dtype], rtol=TOL[dtype])
    y2, last2 = sc.ssd_chunk(*args, state_size=n)
    assert torch.equal(y, y2) and torch.equal(last, last2)
    y3, none = sc.ssd_chunk(*args, state_size=n, last_state=False)
    assert none is None and torch.equal(y, y3)


@pytest.mark.cuda
@pytest.mark.parametrize("size", SSD_SIZES, ids=["tiny", "published"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_step_matches_its_twin_and_holds_rows(cuda, dtype, size):
    """ssd_step against ref.ssd_step_plain over 32 rows, every third held:
    y, the state and the conv window; a held row's states are torch.equal
    to before the step and its y is 0; two calls equal."""
    from repro_torch.kernels import ref

    g = torch.Generator(device=cuda).manual_seed(5)
    rows = 32
    xbc, dt, conv, w, b, bias, alog, d, state = _ssd_step_args(cuda, g, rows, *size, dtype)
    active = torch.arange(rows, device=cuda) % 3 != 0
    conv0, state0 = conv.clone(), state.clone()
    conv_p, state_p = conv.clone(), state.clone()
    y = ops.ssd_step(xbc, dt, conv, w, b, bias, alog, d, state, active)
    want = ref.ssd_step_plain(xbc, dt, conv_p, w, b, bias, alog, d, state_p, active)
    torch.testing.assert_close(y.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(state, state_p, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(conv, conv_p, atol=TOL[dtype], rtol=TOL[dtype])
    held = ~active
    assert torch.equal(state[held], state0[held]) and torch.equal(conv[held], conv0[held])
    assert float(y[held].abs().max()) == 0.0
    conv_r, state_r = conv0.clone(), state0.clone()
    y_r = ops.ssd_step(xbc, dt, conv_r, w, b, bias, alog, d, state_r, active)
    assert torch.equal(y, y_r) and torch.equal(state, state_r) and torch.equal(conv, conv_r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_rownorm_matches_its_chain(cuda, dtype):
    """The row norm's gated form, RMSNorm(x * silu(gate)), against the
    plain chain, the gate a strided view; the ungated launch unchanged."""
    g = torch.Generator(device=cuda).manual_seed(9)
    proj = torch.randn((300, 2 * 512 + 24), generator=g, device=cuda).to(dtype)
    x = torch.randn((300, 512), generator=g, device=cuda).to(dtype)
    w = (0.1 * torch.randn(512, generator=g, device=cuda)).to(dtype)
    gate = proj[:, :512]
    got = ops.rownorm(x, w, eps=1e-5, center=False, gate=gate)
    want = rownorm_plain(x, w, eps=1e-5, center=False, gate=gate)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    plain = ops.rownorm(x, w, eps=1e-5, center=False)
    assert not torch.equal(plain, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_active_holds_rows(cuda, dtype):
    """wkv6's decode step with an active mask, in place on its arena state:
    stepped rows as the unmasked kernel gives them, held rows' state
    torch.equal to before and their output 0."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, h, k = 6, 4, 64
    r, kk, v = (torch.randn((b, 1, h, k), generator=g, device=cuda).to(dtype) for _ in range(3))
    w = torch.rand((b, 1, h, k), generator=g, device=cuda) * 0.5 + 0.4
    u = torch.randn((h, k), generator=g, device=cuda).to(dtype)
    state = torch.randn((b, h, k, k), generator=g, device=cuda)
    active = torch.tensor([True, False, True, False, False, True], device=cuda)
    want, want_state = wk.wkv6(r, kk, v, w, u, state.clone())
    before = state.clone()
    out, new = ops.wkv6(r, kk, v, w, u, state, state_out=state, active=active)
    assert new.data_ptr() == state.data_ptr()
    assert torch.equal(out[active], want[active]) and torch.equal(state[active], want_state[active])
    assert torch.equal(state[~active], before[~active]) and float(out[~active].abs().max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-4.0-h-micro", "rwkv6-1.6b", "recurrentgemma-9b"])
def test_held_rows_state_unchanged_by_a_step(cuda, arch):
    """Leased rows a decode replay holds (no frame this step) keep every
    recurrent leaf torch.equal to before the step; stepped rows move."""
    eng = _graph_engine(cuda, arch, torch.bfloat16)
    slots = eng.alloc_slots(arch, GSEQ, 5, start_pos=3)
    arena = eng.arena(arch, GSEQ)
    for _ in range(2):  # the first call runs eagerly and captures; then replays
        eng.dispatch(arch, (GSEQ,), 5, "decode", slots=slots,
                     payload={s: 5 + s for s in slots}).wait()
    held, stepped = [slots[1], slots[3]], [slots[0], slots[2], slots[4]]
    recurrent = [(name, t) for e in arena.cache["super"] + arena.cache["tail"]
                 for name, t in e.items() if name not in ("k", "v", "pos")]
    snap = [t.clone() for _, t in recurrent]
    eng.dispatch(arch, (GSEQ,), 5, "decode", slots=slots, payload={s: 9 for s in slots},
                 step_rows=stepped).wait()
    axis = lambda t: 1 if any(t is u for e in arena.cache["super"] for u in e.values()) else 0
    for (name, t), old in zip(recurrent, snap):
        ax = axis(t)
        assert torch.equal(t.index_select(ax, torch.tensor(held, device=cuda)),
                           old.index_select(ax, torch.tensor(held, device=cuda))), name
    assert any(not torch.equal(t, old) for (_, t), old in zip(recurrent, snap))

