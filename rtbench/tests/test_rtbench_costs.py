"""Kernel operation and byte counts against counts made by hand."""
import pytest

from rtbench import spec
from rtbench.costs import model, peaks

COSTS = spec.kernel_costs()


@pytest.mark.parametrize("ctx,flops,nbytes", [
    # granite: H 32, KV 8, D 64, bf16. One row at 100 positions:
    # 4*32*64*100 ops; K and V: 2*100*8*64*2 bytes, q and out 2*32*64*2.
    ([100], 819200, 204800 + 8192),
    # Three rows at 1, 10 and 600 positions.
    ([1, 10, 600], 4 * 32 * 64 * 611, 2 * 611 * 8 * 64 * 2 + 3 * 8192),
])
def test_decode_attention(ctx, flops, nbytes):
    got = COSTS["decode_attention"].launch_cost(dict(ctx=ctx, H=32, KV=8, D=64))
    assert got == (flops, nbytes)


@pytest.mark.parametrize("b,s,flops,nbytes", [
    # 1 x 4 tokens, H 2, KV 1, D 8: 10 causal pairs x 4*2*8 ops; q, o: 4*2*8*2
    # bytes each, k, v: 4*1*8*2 each.
    (1, 4, 10 * 64, 2 * 128 + 2 * 64),
    # granite's 8 x 512: pairs 512*513/2 a row.
    (8, 512, 4 * 8 * 32 * 64 * (512 * 513 // 2), 8 * 512 * (64 + 16) * 64 * 2),
])
def test_flash_attention(b, s, flops, nbytes):
    h, kv, d = (2, 1, 8) if s == 4 else (32, 8, 64)
    got = COSTS["flash_attention"].launch_cost(dict(B=b, S=s, H=h, KV=kv, D=d))
    assert got == (flops, nbytes)


@pytest.mark.parametrize("shape,flops,nbytes", [
    # B1 S2 H1 K=V=2, no state in: r, k, v bf16 2*(2+2+2)*2 = 24 bytes, w
    # f32 2*2*4 = 16, u 4, out 2*2*2 = 8, state out 16; ops 7*2*4 = 56.
    (dict(B=1, S=2, H=1, K=2, V=2), 56, 24 + 16 + 4 + 8 + 16),
    # rwkv6 decode: B 32, S 1, H 32, K = V = 64, state read and written.
    (dict(B=32, S=1, H=32, K=64, V=64, state_in=True), 7 * 32 * 32 * 64 * 64,
     32 * 32 * (128 + 64) * 2 + 32 * 32 * 64 * 4 + 32 * 64 * 2 + 32 * 32 * 64 * 2
     + 2 * 32 * 32 * 64 * 64 * 4),
])
def test_wkv6(shape, flops, nbytes):
    assert COSTS["wkv6"].launch_cost(shape) == (flops, nbytes)


def test_every_served_kernel_has_costs_and_a_name_pattern():
    assert {"decode_attention", "flash_attention", "wkv6"} <= set(COSTS)
    import re
    assert re.search(COSTS["decode_attention"].MATCH, "void decode_mma_kernel<64>(...)")
    assert re.search(COSTS["flash_attention"].MATCH, "flash_wgmma_kernel")
    assert not re.search(COSTS["flash_attention"].MATCH, "dq_wgmma_kernel")
    assert re.search(COSTS["wkv6"].MATCH, "wkv6_chunk_out_kernel")
    assert not re.search(COSTS["wkv6"].MATCH, "wkv6_bwd_kernel")


def test_bound_is_the_larger_term():
    assert peaks.bound_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_seconds(0, 3.35e12) == pytest.approx(1.0)


DIMS = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=None, d_ff=16,
            vocab_size=10)


def test_model_flops_by_hand():
    attn = spec.family("attn")
    # attn block weights: q 8*8, k and v 8*4 each, o 8*8, FFN 3*8*16 = 544.
    assert attn.block_matmul_params(DIMS) == 64 + 64 + 64 + 384
    # one token at context 3: 2 layers x (2*576 + 4*2*4*3), head 2*8*10.
    assert model.decode_step_flops(attn, DIMS, [3]) == 2 * (1152 + 96) + 160
    # a prefill row of 2 tokens: contexts 1 and 2, head once.
    want = 2 * (2 * 1152 + 32 * (1 + 2)) + 160
    assert model.prefill_flops(attn, DIMS, 3, 2) == 3 * want


GRANITE = dict(n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=None)
RWKV = dict(n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=None)


def _job(kind, **kw):
    from rtbench.harness import JobRecord
    return JobRecord(n=0, kind=kind, length=kw.pop("length", 1), real_rows=kw.pop("rows", 1),
                     bucket=kw.pop("bucket", 1), host_ns=0, release_t=0.0, frames=[], **kw)


@pytest.mark.parametrize("kernel,model,job,shape", [
    # A decode step of two active rows at contexts 5 and 9: one launch a layer.
    ("decode_attention", GRANITE, _job("decode", bucket=32, ctx=[5, 9]),
     dict(ctx=[5, 9], H=32, KV=8, D=64)),
    ("decode_attention", GRANITE, _job("prefill", length=512, bucket=4), None),
    # A prefill of 3 real rows in a bucket of 4, 480 tokens: the bucket's rows launched.
    ("flash_attention", GRANITE, _job("prefill", length=480, rows=3, bucket=4),
     dict(B=4, S=480, H=32, KV=8, D=64)),
    ("flash_attention", GRANITE, _job("decode", bucket=32, ctx=[5]), None),
    ("wkv6", RWKV, _job("prefill", length=96, rows=5, bucket=8),
     dict(B=8, S=96, H=32, K=64, V=64, state_in=False)),
    ("wkv6", RWKV, _job("decode", bucket=32, ctx=[1, 2]),
     dict(B=32, S=1, H=32, K=64, V=64, state_in=True)),
])
def test_launch_shapes(kernel, model, job, shape):
    got = COSTS[kernel].launch_shapes(job, model)
    assert got == ([] if shape is None else [shape] * model["n_layers"])


def test_rwkv_flops_by_hand():
    rwkv = spec.family("rwkv")
    d = dict(DIMS, n_heads=2)
    # 6 D^2 (r, k, v, g, o and the channel-mix receptance) + adapters
    # 32 (D + 5 D) + 32 (D + D) + 2 D F: 384 + 1536 + 512 + 256.
    assert rwkv.block_matmul_params(d) == 6 * 64 + 32 * 48 + 32 * 16 + 256
    # the recurrence: 7 K V a head, K = V = 4.
    assert rwkv.mixer_flops(d, 123) == 7 * 2 * 4 * 4
