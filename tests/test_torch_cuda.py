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
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
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
        "decode_attention": 1, "flash_attention": 1}


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
