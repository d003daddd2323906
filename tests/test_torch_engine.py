"""The port's inference engine against the JAX engine, on the CPU.

Both engines serve tiny granite-3-2b with the SAME parameters (the JAX
engine's, converted by ``repro_torch.interop``); prefill outputs and
slot-arena decode logits must agree (logits 2e-3, live rows only).
Also: the allocator's alloc/free/reset, zero decode step builds across
batch sweeps after warm-up, and the staging ring's consumer guard.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as jtiny
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.ingest.staging import StagingRing
from repro_torch.serving.engine import InferenceEngine

MID = "granite-3-2b"
SEQ = 16


@pytest.fixture(scope="module")
def engines():
    jeng = JEngine({MID: jtiny(MID)}, max_slots=4)
    params = interop.params_from_numpy(
        tiny(MID), jax.tree.map(np.asarray, jeng.params[MID]), device="cpu")
    teng = InferenceEngine({MID: tiny(MID)}, max_slots=4, device="cpu", params={MID: params})
    return jeng, teng


def test_prefill_outputs_match_jax(engines):
    jeng, teng = engines
    toks = np.random.default_rng(0).integers(0, 256, size=(3, SEQ)).astype(np.int32)
    jout = np.asarray(jeng.dispatch(MID, (SEQ,), 3, "prefill", payload=toks).wait())
    h = teng.dispatch(MID, (SEQ,), 3, "prefill", payload=toks)
    tout = h.wait().numpy()
    assert h.bucket_batch == 4 and tout.shape == jout.shape == (4,)
    np.testing.assert_array_equal(tout, jout)


def test_slot_arena_decode_logits_match_jax(engines):
    jeng, teng = engines
    seq = 24
    rng = np.random.default_rng(1)
    js = jeng.alloc_slots(MID, seq, 3, start_pos=2)
    ts = teng.alloc_slots(MID, seq, 3, start_pos=2)
    assert js == ts == (0, 1, 2)
    arena = teng.arena(MID, seq)
    cache_ptr = arena.cache["super"][0]["k"].data_ptr()
    for step in range(5):
        payload = {s: int(rng.integers(0, 256)) for s in ts}
        rows = None if step % 2 == 0 else [0, 2]  # row 1 idle on odd steps
        jl = np.asarray(jeng.dispatch(MID, (seq,), 3, "decode", slots=js,
                                      payload=payload, step_rows=rows).wait())
        tl = teng.dispatch(MID, (seq,), 3, "decode", slots=ts, payload=payload,
                           step_rows=rows).wait()
        live = list(ts) if rows is None else rows
        np.testing.assert_allclose(tl.numpy()[live], jl[live], atol=2e-3, rtol=2e-3)
        np.testing.assert_array_equal(arena.cur.numpy(),
                                      np.asarray(jeng.arena(MID, seq).cur))
    # One resident arena, updated in place across steps.
    assert teng.arena(MID, seq).cache["super"][0]["k"].data_ptr() == cache_ptr
    assert arena.cur.tolist() == [7, 5, 7, 0]
    jeng.free_slots(MID, seq, js)
    teng.free_slots(MID, seq, ts)


def test_cursor_clamps_at_cache_edge_like_jax(engines):
    jeng, teng = engines
    seq = 12
    js = jeng.alloc_slots(MID, seq, 2, start_pos=seq - 2)
    ts = teng.alloc_slots(MID, seq, 2, start_pos=seq - 2)
    for _ in range(3):
        jl = np.asarray(jeng.dispatch(MID, (seq,), 2, "decode", slots=js,
                                      payload={0: 3, 1: 4}).wait())
        tl = teng.dispatch(MID, (seq,), 2, "decode", slots=ts, payload={0: 3, 1: 4}).wait()
        np.testing.assert_allclose(tl.numpy()[:2], jl[:2], atol=2e-3, rtol=2e-3)
    assert teng.arena(MID, seq).cur.tolist()[:2] == [seq - 1, seq - 1]
    np.testing.assert_array_equal(teng.arena(MID, seq).cur.numpy(),
                                  np.asarray(jeng.arena(MID, seq).cur))
    jeng.free_slots(MID, seq, js)
    teng.free_slots(MID, seq, ts)


def test_alloc_free_reset_rows():
    eng = InferenceEngine({MID: tiny(MID)}, max_slots=4, device="cpu")
    seq = 8
    a = eng.alloc_slots(MID, seq, 2)
    arena = eng.arena(MID, seq)
    k = arena.cache["super"][0]["k"]
    ptr = k.data_ptr()
    eng.dispatch(MID, (seq,), 2, "decode", slots=a, payload={0: 5, 1: 6}).wait()
    assert float(k[:, 0, 0].abs().sum()) > 0  # row 0 written at cursor 0
    assert arena.active.tolist() == [True, True, False, False]
    assert arena.cur.tolist() == [1, 1, 0, 0]
    eng.free_slots(MID, seq, [0])
    assert arena.active.tolist() == [False, True, False, False]
    with pytest.raises(ValueError, match="double free"):
        eng.free_slots(MID, seq, [0])
    with pytest.raises(ValueError, match="out of range"):
        eng.free_slots(MID, seq, [9])
    b = eng.alloc_slots(MID, seq, 3, start_pos=3)
    assert b == (0, 2, 3)
    # Recycled row 0 was wiped in place; live row 1 kept its KV.
    assert k.data_ptr() == ptr
    assert float(k[:, 0].abs().sum()) == 0.0
    assert float(k[:, 1, 0].abs().sum()) > 0
    assert arena.cur.tolist() == [3, 1, 3, 3]
    assert arena.allocs == 5 and arena.resets == 5
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.alloc_slots(MID, seq, 1)
    with pytest.raises(ValueError, match="ALL live rows"):
        eng.dispatch(MID, (seq,), 2, "decode", slots=[0, 1])
    with pytest.raises(ValueError, match="allocator-live"):
        eng.dispatch(MID, (seq,), 2, "decode")
    tele = eng.telemetry()
    assert tele["arenas"][f"{MID}/seq{seq}"]["occupied"] == 4
    assert eng.arena_nbytes(MID, seq) == 2 * 2 * 4 * seq * 2 * 16 * 4


def test_zero_decode_builds_across_batch_sweep():
    eng = InferenceEngine({MID: tiny(MID)}, max_slots=8, device="cpu")
    eng.warmup(MID, (SEQ,), [8], kind="decode")
    assert eng.stats["decode_compiles"] == 1
    eng.reset_stats()
    for b in (1, 2, 3, 5, 8, 6, 4, 2, 1):
        logits = eng.dispatch(MID, (SEQ,), b, "decode").wait()
        assert tuple(logits.shape) == (8, 256)
        assert bool(torch.isfinite(logits[:b]).all())
    assert eng.stats["decode_compiles"] == 0
    assert eng.stats["dispatches"] == 9
    assert eng.padding_waste == 0.0
    with pytest.raises(ValueError, match="max_slots"):
        eng.dispatch(MID, (SEQ,), 9, "decode")


def test_blind_padding_measures_waste():
    """masked_decode=False runs every arena row as live (the padding A/B);
    live rows' logits do not change, the measured waste does."""
    masked = InferenceEngine({MID: tiny(MID)}, max_slots=8, device="cpu")
    blind = InferenceEngine({MID: tiny(MID)}, max_slots=8, device="cpu",
                            masked_decode=False, params=masked.params)
    toks = np.array([5, 9, 17], np.int32)
    a = masked.dispatch(MID, (SEQ,), 3, "decode", payload=toks).wait()
    b = blind.dispatch(MID, (SEQ,), 3, "decode", payload=toks).wait()
    torch.testing.assert_close(a[:3], b[:3])
    assert masked.padding_waste == 0.0
    assert blind.padding_waste == pytest.approx(1 - 3 / 8)


def test_staging_ring_consumer_guard():
    """A scratch buffer is refilled only after its previous consumer's
    wait ran: the guard is what keeps an async copy from reading bytes
    the next fill overwrote."""
    ring = StagingRing((2, 3), np.int32, depth=2, device="cpu")
    events = []

    def consumer(tag):
        return lambda: events.append(("wait", tag))

    a = ring.stage_rows(np.ones((2, 3), np.int32), 2)
    ring.attach_consumer(consumer("a"))
    b = ring.stage_rows(np.full((1, 3), 2, np.int32), 1)
    ring.attach_consumer(consumer("b"))
    assert events == [] and a.tolist() == [[1] * 3] * 2
    assert b.tolist() == [[2] * 3, [0] * 3]

    def fill(buf):
        events.append(("fill", int(buf[0, 0])))  # still holds "a"'s bytes
        buf[:] = 7

    c = ring.stage(fill)
    assert events == [("wait", "a"), ("fill", 1)]
    assert c.tolist() == [[7] * 3] * 2
    assert ring.consumer_waits == 1 and ring.fills == 3
    assert ring.host_allocs == 2 and ring.bytes_staged == 3 * 24
    with pytest.raises(ValueError, match="dtype"):
        ring.stage_rows(np.ones((2, 3), np.float32), 2)
    with pytest.raises(ValueError, match="depth"):
        StagingRing((2,), depth=1, device="cpu")


def test_engine_refuses_unported_options_and_missing_cuda():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine({MID: tiny(MID)}, chunk_depth=2, device="cpu")
    if not torch.cuda.is_available():
        # No silent CPU fallback: asking for the card without one raises.
        with pytest.raises(RuntimeError, match="cuda"):
            InferenceEngine({MID: tiny(MID)}, device="cuda")
