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
from repro_torch.kernels.ref import decode_attention_split_plain
from repro_torch.kernels.rglru import rglru_scan_plain
from repro_torch.kernels.wkv6 import wkv6_plain
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
