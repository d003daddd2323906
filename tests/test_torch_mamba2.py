"""granite-4.0-h-micro's Mamba-2 block on the CPU (the port's own: the
JAX package has no such block, so nothing here imports it).

- The chunked ``ssd_chunk`` kernel's plain twin (``ref.ssd_chunked_plain``)
  against the step-by-step recurrence (``ref.ssd_ref``) at S = 1, 63, the
  chunk, the chunk + 1 and 992, the last state included, and with more
  than one group; ``ssd_step``'s twin as one step of it, held rows
  untouched.
- The tiny model: full forward, token-by-token decode and prefill then
  decode agree, on the kernel route (the twins on the CPU) and dense.
- Held arena rows (the departure from the reference, ROADMAP "Deliberate
  departures"): a row that idles a step and then takes a token equals a
  fresh row that takes it, bit for bit in every cache leaf and in the
  logits, for granite-4.0-h-micro, rwkv6 and recurrentgemma; in the
  engine, a k-step chunk with held rows still equals k steps.
- Granite's multipliers at their defaults leave tiny granite-3-2b's
  logits ``torch.equal`` to the trunk the port ran before them; set, they
  do what the published config says.
- The decode arena's leaves and their bytes at the published widths (on
  the meta device), the dry run on the tiny config, the slice's stepped
  and held row counters.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config, tiny
from repro_torch.kernels import ref
from repro_torch.models import model_for
from repro_torch.models.attention import mha
from repro_torch.models.layers import apply_mlp, apply_norm, embed_lookup, tree_leaves, unembed
from repro_torch.serving.engine import InferenceEngine

ARCH = "granite-4.0-h-micro"


def _ssd_args(b, s, h, p, n, g=1, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, dtype=torch.float32)
    return (r(b, s, h, p).to(dtype), r(b, s, h).to(dtype), (r(h) - 2.0).to(dtype),
            (0.5 * r(h) + 0.5).to(dtype), r(b, s, g, n).to(dtype), r(b, s, g, n).to(dtype),
            r(h).to(dtype))


@pytest.mark.parametrize("s", [1, 63, ref.SSD_CHUNK, ref.SSD_CHUNK + 1, 992])
def test_chunked_twin_equals_the_sequential_recurrence(s):
    args = _ssd_args(2, s, 3, 8, 16, seed=s)
    y, last = ref.ssd_chunked_plain(*args)
    want, want_last = ref.ssd_ref(*args)
    torch.testing.assert_close(y, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(last, want_last, atol=2e-5, rtol=2e-5)
    # float64 throughout the oracle: the twin's float32 departs by rounding only
    y64, last64 = ref.ssd_ref(*(a.double() for a in args))
    torch.testing.assert_close(y.double(), y64, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(last.double(), last64, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("chunk", [16, 64, 100])
def test_chunk_length_does_not_change_the_result(chunk):
    args = _ssd_args(1, 150, 4, 8, 16, g=2, seed=chunk)
    y, last = ref.ssd_chunked_plain(*args, chunk=chunk)
    want, want_last = ref.ssd_ref(*args)
    torch.testing.assert_close(y, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(last, want_last, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s", [1, 70])
def test_chunk_twin_takes_the_conv_first(s):
    """``ssd_chunk``'s twin: the conv and SiLU over the projection's xBC
    columns from a zero window, then the chunked recurrence; against the
    conv written out and the step-by-step recurrence."""
    gen = torch.Generator().manual_seed(s)
    h, p, n = 3, 8, 16
    cc = h * p + 2 * n
    xbc = torch.randn((2, s, cc), generator=gen)
    w, bias = torch.randn((4, cc), generator=gen), torch.randn(cc, generator=gen)
    dt = torch.randn((2, s, h), generator=gen)
    dt_bias, a_log, d = torch.randn(h, generator=gen) - 2, 0.5 * torch.randn(h, generator=gen), \
        torch.randn(h, generator=gen)
    y, last = ref.ssd_chunk_plain(xbc, w, bias, dt, dt_bias, a_log, d, state_size=n)
    padded = torch.nn.functional.pad(xbc, (0, 0, 3, 0))
    u = torch.nn.functional.silu(sum(padded[:, k:k + s] * w[k] for k in range(4)) + bias)
    want, want_last = ref.ssd_ref(u[..., : h * p].reshape(2, s, h, p), dt, dt_bias, a_log,
                                  u[..., h * p:h * p + n, None].transpose(2, 3),
                                  u[..., h * p + n:, None].transpose(2, 3), d)
    torch.testing.assert_close(y, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(last, want_last, atol=2e-5, rtol=2e-5)


def test_step_twin_is_one_step_and_holds_rows():
    gen = torch.Generator().manual_seed(1)
    b, h, p, n = 5, 2, 8, 16
    cc = h * p + 2 * n
    r = lambda *shape: torch.randn(shape, generator=gen)
    xbc, dt, conv = r(b, cc), r(b, h), r(b, 3, cc)
    w, bias = r(4, cc), r(cc)
    dt_bias, a_log, d = r(h) - 2, 0.5 * r(h), r(h)
    state = r(b, h, p, n)
    active = torch.tensor([True, False, True, True, False])
    conv0, state0 = conv.clone(), state.clone()
    y = ref.ssd_step_plain(xbc, dt, conv, w, bias, dt_bias, a_log, d, state, active)
    window = torch.cat([conv0, xbc[:, None]], dim=1)
    u = torch.nn.functional.silu((window * w).sum(1) + bias)
    want, want_state = ref.ssd_ref(u[:, None, : h * p].reshape(b, 1, h, p), dt[:, None], dt_bias,
                                   a_log, u[:, None, h * p:h * p + n, None].transpose(2, 3),
                                   u[:, None, h * p + n:, None].transpose(2, 3), d, state0)
    live, held = active, ~active
    torch.testing.assert_close(y[live], want[live, 0].reshape(-1, h * p), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(state[live], want_state[live], atol=1e-6, rtol=1e-6)
    assert torch.equal(conv[live], window[live, 1:])
    assert torch.equal(state[held], state0[held]) and torch.equal(conv[held], conv0[held])
    assert float(y[held].abs().max()) == 0.0


@pytest.mark.parametrize("impl", ["xla", "dense"])
def test_tiny_forward_decode_and_prefill_agree(impl):
    cfg = dataclasses.replace(tiny(ARCH), impl=impl)
    assert cfg.n_layers == 10 and cfg.block_pattern.count("attn") == 1
    m = model_for(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    # Mamba-2's own parameters off their zero / one inits, so each matters.
    gen = torch.Generator().manual_seed(1)
    for entry in params["super"]:
        for name in ("conv_b", "dt_bias", "a_log", "d_skip", "norm"):
            if name in entry["mixer"]:
                leaf = entry["mixer"][name]
                leaf.add_(0.3 * torch.randn(leaf.shape, generator=gen))
    toks = torch.randint(0, cfg.vocab_size, (2, 70), generator=gen)
    with torch.no_grad():
        full, _ = m.forward(params, toks)
        cache = m.init_cache(2, 80, device="cpu")
        steps = []
        for t in range(toks.shape[1]):
            lg, _ = m.decode_step(params, cache, toks[:, t], torch.full((2,), t, dtype=torch.int32))
            steps.append(lg)
        torch.testing.assert_close(torch.stack(steps, 1), full, atol=2e-5, rtol=0)
        cache = m.init_cache(2, 80, device="cpu")
        last, _ = m.prefill(params, cache, toks[:, :65])
        torch.testing.assert_close(last, full[:, 64], atol=2e-5, rtol=0)
        for t in range(65, 70):
            lg, _ = m.decode_step(params, cache, toks[:, t], torch.full((2,), t, dtype=torch.int32))
            torch.testing.assert_close(lg, full[:, t], atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch", [ARCH, "rwkv6-1.6b", "recurrentgemma-9b"])
def test_idle_then_a_token_equals_a_fresh_row(arch):
    """A row held for a step (``active`` off: the engine's idle lease) and
    then given token 7 at its frozen cursor equals a fresh row given token
    7: every cache leaf and the logits, bit for bit. The reference steps
    the held row on a phantom zero token instead."""
    cfg = tiny(arch)
    m = model_for(cfg)
    params = m.init(torch.Generator().manual_seed(2), device="cpu")
    cur = torch.zeros(1, dtype=torch.int32)
    on, off = torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool)
    seven = torch.full((1,), 7, dtype=torch.int32)
    with torch.no_grad():
        idled = m.init_cache(1, 16, device="cpu")
        m.decode_step(params, idled, torch.zeros(1, dtype=torch.int32), cur, active=off)
        got, _ = m.decode_step(params, idled, seven, cur, active=on)
        fresh = m.init_cache(1, 16, device="cpu")
        want, _ = m.decode_step(params, fresh, seven, cur, active=on)
    assert torch.equal(got, want)
    for a, b in zip(tree_leaves(idled), tree_leaves(fresh)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [ARCH, "rwkv6-1.6b", "recurrentgemma-9b"])
def test_chunk_with_held_rows_equals_its_steps(arch):
    """On the engine's arena: a 4-step chunk whose steps hold some leased
    rows against 4 single steps on a twin engine, every arena leaf and
    each step's logits bit for bit; a row held at every step keeps its
    recurrent state."""
    cfg = tiny(arch)
    a = InferenceEngine({arch: cfg}, max_slots=4, chunk_depth=4, device="cpu")
    b = InferenceEngine({arch: cfg}, max_slots=4, chunk_depth=4, device="cpu",
                        params={arch: a.params[arch]})
    seq = 24
    for e in (a, b):
        e.alloc_slots(arch, seq, 3, start_pos=2)
    live = [0, 1, 2]
    rows = [[0, 1], [0], None, [0, 2]]
    rng = np.random.default_rng(4)
    payloads = [{r: int(rng.integers(0, 256)) for r in (live if rs is None else rs)}
                for rs in rows]
    for e in (a, b):  # one step with every row, so that each holds a state
        e.dispatch(arch, (seq,), 3, "decode", slots=live, payload={0: 1, 1: 2, 2: 3}).wait()
    snap = [t.clone() for t in tree_leaves(a.arena(arch, seq).cache)]
    chunk = a.decode_chunk(arch, (seq,), 3, 4, slots=live, payloads=payloads,
                           step_rows=[[0, 1], [0], None, [0]]).wait()
    steps = [b.dispatch(arch, (seq,), 3, "decode", slots=live, payload=payloads[i],
                        step_rows=rs).wait()
             for i, rs in enumerate([[0, 1], [0], None, [0]])]
    for i in range(4):
        assert torch.equal(chunk[i], steps[i])
    cache_a = a.arena(arch, seq).cache
    for la, lb in zip(tree_leaves(cache_a), tree_leaves(b.arena(arch, seq).cache)):
        assert torch.equal(la, lb)
    # Row 1 stepped at steps 0 and 2 only, row 2 at step 2: both moved; the
    # unleased row 3 never did.
    recurrent = [(names, t) for names, t in _named_leaves(cache_a)
                 if names[-1] not in ("k", "v", "pos")]
    assert recurrent
    for (names, t), old in zip(recurrent, [s for (nm, _), s in
                                           zip(_named_leaves(cache_a), snap)
                                           if nm[-1] not in ("k", "v", "pos")]):
        axis = 1 if names[0] == "super" else 0
        assert torch.equal(t.select(axis, 3), old.select(axis, 3))


def _named_leaves(cache):
    out = []
    for part in ("super", "tail"):
        for j, entry in enumerate(cache[part]):
            for name, t in entry.items():
                out.append(((part, j, name), t))
    return out


def _trunk_before_multipliers(m, params, toks):
    """The port's dense-decoder trunk as it ran before Granite's
    multipliers and ``norm_eps`` existed."""
    cfg = m.cfg
    pos = torch.arange(toks.shape[1]).expand(toks.shape)
    x = embed_lookup(params["embed"], toks)
    for kind, p, _ in m._layers(params):
        h = apply_norm(x, p["norm1"], cfg.norm, cfg.impl)
        x = x + mha(p["mixer"], h, pos, causal=True, window=None, rope_theta=cfg.rope_theta,
                    rope_kind=cfg.rope_kind, impl=cfg.impl)
        x = x + apply_mlp(apply_norm(x, p["norm2"], cfg.norm, cfg.impl), p["ffn"],
                          cfg.activation)
    return unembed(apply_norm(x, params["final_norm"], cfg.norm, cfg.impl), params["embed"])


def test_multiplier_defaults_leave_granite_logits_unchanged():
    cfg = tiny("granite-3-2b")
    m = model_for(cfg)
    params = m.init(torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got, _ = m.forward(params, toks)
        assert torch.equal(got, _trunk_before_multipliers(m, params, toks))
        scaled, _ = model_for(dataclasses.replace(cfg, logits_scaling=8.0)).forward(params, toks)
        assert torch.equal(scaled, got / 8.0)
        for field, value in (("embedding_multiplier", 12.0), ("residual_multiplier", 0.22),
                             ("attention_multiplier", 0.015625), ("norm_eps", 1e-5)):
            other, _ = model_for(dataclasses.replace(cfg, **{field: value})).forward(params, toks)
            assert not torch.equal(other, got), field


def test_attention_multiplier_scales_the_scores():
    """q pre-scaled by attention_multiplier * sqrt(head_dim) gives the scores
    attention_multiplier * q.k, as Granite's attention computes them."""
    cfg = dataclasses.replace(tiny("granite-3-2b"), attention_multiplier=0.05, impl="dense")
    m = model_for(cfg)
    params = m.init(torch.Generator().manual_seed(6), device="cpu")
    p = params["super"][0]["mixer"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((1, 5, cfg.d_model), generator=torch.Generator().manual_seed(7))
    pos = torch.arange(5)[None]
    hd = cfg.resolved_head_dim
    got = mha(p, x, pos, rope_kind="none", impl="dense", q_scale=0.05 * hd ** 0.5)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"]).repeat_interleave(cfg.n_heads // cfg.n_kv_heads, 2)
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"]).repeat_interleave(cfg.n_heads // cfg.n_kv_heads, 2)
    scores = torch.einsum("bqhk,bshk->bhqs", q, k) * 0.05
    scores = scores.masked_fill(~torch.ones(5, 5, dtype=torch.bool).tril(), float("-inf"))
    o = torch.einsum("bhqs,bshk->bqhk", scores.softmax(-1), v)
    want = torch.einsum("bqhk,hkd->bqd", o, p["wo"])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_published_arena_leaves_and_bytes():
    cfg = get_config(ARCH)
    assert cfg.n_layers == 40 and cfg.n_super == 4 and cfg.tail_kinds == ()
    assert [i for i, k in enumerate(cfg.pattern_layers) if k == "attn"] == [5, 15, 25, 35]
    m = model_for(cfg)
    spec = m.abstract_params()
    mixer = spec["super"][0]["mixer"]
    assert tuple(mixer["in_proj"].shape) == (4, 2048, 4096 + 4352 + 64)
    assert tuple(mixer["conv_w"].shape) == (4, 4, 4352)
    assert tuple(mixer["out_proj"].shape) == (4, 4096, 2048)
    n_params = sum(t.numel() for t in tree_leaves(spec))
    assert 3.18e9 < n_params < 3.20e9
    cache = m.init_cache(32, 2048, device="meta")
    ssm = [e["ssm"] for e in cache["super"] if "ssm" in e]
    assert len(ssm) == 9 and tuple(ssm[0].shape) == (4, 32, 64, 64, 128)
    assert tuple(cache["super"][0]["conv"].shape) == (4, 32, 3, 4352)
    ssm_bytes = sum(t.numel() * t.element_size() for t in ssm)
    assert ssm_bytes == 36 * 32 * 64 * 64 * 128 * 4  # 2.42 GB of float32 state


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dry_run_takes_the_config(shape):
    from repro_torch.launch import dryrun

    cell = dryrun.run_cell(ARCH, shape, False, cfg=tiny(ARCH), seq_len=128, global_batch=256)
    assert cell["ok"], cell.get("error")


def test_slot_decode_counts_stepped_and_held_rows():
    """The slice's Metrics count a slot-mode decode step's stepped rows and
    the leased rows it held, and the EDF worker's device_submit span
    carries the two numbers."""
    from repro_torch import core
    from repro_torch.core.telemetry import FrameTracer
    from repro_torch.serving.batcher_bridge import build_live_cluster

    cfg = tiny(ARCH)
    cluster, slices = build_live_cluster(
        {ARCH: cfg}, [(ARCH, (16,), "decode")], slice_names=("slice0",), batch_sizes=(1, 2),
        profile_runs=1, nonrt_cap=4, device="cpu")
    sl = slices["slice0"]
    tracer = FrameTracer()
    cluster.attach_tracer(tracer)
    engine = sl.engine
    live = engine.alloc_slots(ARCH, 16, 3)
    leases = sl.leases
    cat = core.Category(ARCH, (16,))
    frames = []
    for i, rid in enumerate((101, 102, 103)):
        leases[rid] = (ARCH, 16, (live[i],))
    for rid in (101, 103):
        frames.append(core.Frame(request_id=rid, category=cat, index=0, arrival_time=0.0,
                                 deadline=10.0, payload=np.int32(5)))
    job = core.JobInstance(category=cat, frames=frames, release_time=0.0, relative_deadline=10.0,
                           shape_key=(16,))
    before = (sl.scheduler.metrics.decode_rows_stepped, sl.scheduler.metrics.decode_rows_held)
    sl.device.dispatch_fn(job).wait()
    m = sl.scheduler.metrics
    assert (m.decode_rows_stepped - before[0], m.decode_rows_held - before[1]) == (2, 1)
    assert job.decode_rows == (2, 1)
    sl.device.close()
