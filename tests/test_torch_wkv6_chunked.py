"""The chunked wkv6 design's plain twin against the JAX package, on the CPU.

``ref.wkv6_chunked_plain`` repeats the arithmetic of the chunked CUDA
kernel (``csrc/wkv6.cu``): the clamp of log w, the sub-block reference
points, the per-chunk carry and the operands rounded to bf16 as the
tensor cores take them. Here it is held against the JAX oracle
``repro.kernels.ref.wkv6_ref`` and the Pallas ``wkv6`` in interpret mode
(through ``repro.kernels.ops``, as ``tests/test_kernels.py`` runs it), on
the same seeded numpy inputs, at the reference's kernel tolerances: 2e-5
in float32 and 2e-2 in bfloat16 (``tests/test_kernels.py``).

Shapes: the reference's ``WKV_SHAPES`` (S ragged against the 64-step
chunk) and S = 64, 65 and 512 at K = V = 64; decays at the extremes
(w = 0, w = 1e-40, w = 1, strong and mild channels in one chunk) and as
rwkv6's ``_rwkv6_inputs`` makes them from JAX-initialised parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import tiny as jtiny
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model_for as jmodel_for
from repro_torch import interop
from repro_torch.configs.registry import tiny
from repro_torch.kernels import wkv6 as twkv6
from repro_torch.kernels.ref import wkv6_chunked_plain, wkv6_ref
from repro_torch.models import recurrent as trec

KEY = jax.random.PRNGKey(3)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WKV_SHAPES = [(1, 8, 2, 8), (2, 90, 2, 16), (1, 200, 4, 64), (2, 33, 8, 32)]
CHUNK_SHAPES = [(1, 64, 3, 64), (2, 65, 2, 64), (1, 512, 2, 64)]


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    assert np.isfinite(got).all(), "non-finite output"
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _inputs(rng, b, s, h, k, w=None):
    """The reference sweep's distributions: r/k/v scaled 0.5, w in
    (0.45, 0.95) unless given, u and the state scaled 0.1."""
    r, kk, v = (rng.standard_normal((b, s, h, k), np.float32) * 0.5 for _ in range(3))
    if w is None:
        w = _sigmoid(rng.standard_normal((b, s, h, k))).astype(np.float32) * 0.5 + 0.45
    u = rng.standard_normal((h, k), np.float32) * 0.1
    st0 = rng.standard_normal((b, h, k, k), np.float32) * 0.1
    return r, kk, v, w, u, st0


def _against_jax(r, kk, v, w, u, st0, dtype, *, pallas=True):
    """Run the twin on the inputs in ``dtype`` and hold it against the JAX
    oracle (and the Pallas kernel), output and last state."""
    jd, td = DTYPES[dtype]
    targs = [torch.from_numpy(np.ascontiguousarray(x)).to(td) for x in (r, kk, v, w, u)]
    jargs = [jnp.asarray(x).astype(jd) for x in (r, kk, v, w, u)]
    tst = None if st0 is None else torch.from_numpy(st0)
    jst = None if st0 is None else jnp.asarray(st0)
    out, last = wkv6_chunked_plain(*targs, tst)
    assert out.dtype == td and last.dtype == torch.float32
    assert tuple(out.shape) == r.shape[:3] + (v.shape[-1],)
    _close(last, last, 0.0)  # finite
    wants = [jref.wkv6_ref(*jargs, jst)]
    if pallas:
        wants.append(jops.wkv6(*jargs, jst))  # Pallas, interpret mode
    for eo, es in wants:
        _close(out, eo, _tol(dtype))
        _close(last, es, _tol(dtype))
    return out, last


@pytest.mark.parametrize("shape", WKV_SHAPES + CHUNK_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_chunked_twin_matches_jax(shape, dtype, with_state):
    rng = np.random.default_rng(sum(shape) + 11 * with_state)
    r, kk, v, w, u, st0 = _inputs(rng, *shape)
    _against_jax(r, kk, v, w, u, st0 if with_state else None, dtype)


def _extreme_decay(case, rng, b, s, h, k):
    if case == "zero":
        return np.zeros((b, s, h, k), np.float32)
    if case == "denormal":
        return np.full((b, s, h, k), 1e-40, np.float32)
    if case == "one":
        return np.ones((b, s, h, k), np.float32)
    if case == "mixed":  # strong and mild channels side by side in every chunk
        strong = rng.uniform(1e-6, 1e-2, (b, s, h, k)).astype(np.float32)
        mild = rng.uniform(0.99, 1.0, (b, s, h, k)).astype(np.float32)
        return np.where(np.arange(k) % 2 == 0, strong, mild).astype(np.float32)
    # "spikes": mostly mild, with w = 0 steps and 1e-30 steps scattered in.
    w = rng.uniform(0.9, 1.0, (b, s, h, k)).astype(np.float32)
    w[rng.random((b, s, h, k)) < 0.05] = 0.0
    w[rng.random((b, s, h, k)) < 0.05] = 1e-30
    return w


@pytest.mark.parametrize("case", ["zero", "denormal", "one", "mixed", "spikes"])
@pytest.mark.parametrize("shape", [(1, 200, 2, 16), (1, 130, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_twin_extreme_decays(case, shape, dtype):
    rng = np.random.default_rng(len(case) + sum(shape))
    w = _extreme_decay(case, rng, *shape)
    r, kk, v, _, u, st0 = _inputs(rng, *shape, w=w)
    _against_jax(r, kk, v, w, u, st0, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_twin_on_model_decays(dtype):
    """r, k, v and w as rwkv6's time-mix makes them (``_rwkv6_inputs``),
    from the JAX package's own init of tiny rwkv6 carried across by
    ``interop``, over 150 steps (three chunks, the last ragged)."""
    jcfg = jtiny("rwkv6-1.6b")
    tree = jax.tree.map(np.asarray, jmodel_for(jcfg).init(KEY))
    params = interop.params_from_numpy(tiny("rwkv6-1.6b"), tree, device="cpu")
    mixer = {name: leaf[0] for name, leaf in _flat(params["super"][0]["mixer"]).items()}
    rng = np.random.default_rng(5)
    b, s, d = 2, 150, jcfg.d_model
    heads, hd = jcfg.n_heads, jcfg.d_model // jcfg.n_heads
    x = torch.from_numpy(rng.standard_normal((b, s, d), np.float32))
    x_prev = torch.cat([torch.zeros((b, 1, d)), x[:, :-1]], dim=1)
    with torch.no_grad():
        r, k, v, _, w = trec._rwkv6_inputs(_unflat(mixer), x, x_prev)
    r, k, v, w = (t.reshape(b, s, heads, hd).numpy() for t in (r, k, v, w))
    u = mixer["bonus_u"].numpy()
    assert w.min() >= 0.0 and w.max() <= 1.0
    st0 = rng.standard_normal((b, heads, hd, hd), np.float32) * 0.1
    _against_jax(r, k, v, w, u, st0, dtype)


def _flat(tree, pre=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flat(leaf, f"{pre}{name}/"))
        else:
            out[pre + name] = leaf
    return out


def _unflat(flat):
    tree = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = tree
        for name in heads:
            node = node.setdefault(name, {})
        node[last] = leaf
    return tree


@pytest.mark.parametrize("shape", [(2, 90, 2, 16), (1, 512, 2, 64)])
def test_chunked_twin_float32_operands_is_the_exact_chunked_form(shape):
    """On bfloat16 inputs the twin rounds its decayed operands to bf16 as
    the kernel does; asked for float32 operands it agrees with the
    sequential recurrence on the same (bf16-valued) inputs to float32
    precision."""
    rng = np.random.default_rng(sum(shape))
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(rng, *shape)[:5]]
    st0 = torch.from_numpy(rng.standard_normal((shape[0], shape[2], shape[3], shape[3]),
                                               np.float32) * 0.1)
    o32, s32 = wkv6_chunked_plain(*[a.float() for a in args], st0,
                                  operand_dtype=torch.float32)
    want_o, want_s = wkv6_ref(*[a.float() for a in args], st0)
    _close(o32, want_o, 2e-5)
    _close(s32, want_s, 2e-5)
    o16, s16 = wkv6_chunked_plain(*args, st0)
    assert o16.dtype == torch.bfloat16
    _close(o16, want_o, 2e-2)
    _close(s16, want_s, 2e-2)


@pytest.mark.parametrize("chunk,half", [(32, 4), (64, 8), (128, 16)])
def test_chunked_form_holds_for_any_block_sizes(chunk, half):
    """The chunked arithmetic (float32 operands) is the recurrence for any
    chunk and block length, not only the kernel's 64 and 8."""
    rng = np.random.default_rng(chunk + half)
    r, kk, v, w, u, st0 = _inputs(rng, 2, 200, 2, 16)
    args = [torch.from_numpy(x) for x in (r, kk, v, w, u, st0)]
    out, last = wkv6_chunked_plain(*args, chunk=chunk, half=half)
    eo, es = jref.wkv6_ref(*map(jnp.asarray, (r, kk, v, w, u, st0)))
    _close(out, eo, 2e-5)
    _close(last, es, 2e-5)


@pytest.mark.parametrize("dtype,s,chunked", [
    (torch.bfloat16, 1, False), (torch.bfloat16, 63, False), (torch.bfloat16, 64, True),
    (torch.bfloat16, 65, True), (torch.bfloat16, 512, True), (torch.float32, 1, False),
    (torch.float32, 64, False), (torch.float32, 512, False),
])
def test_dispatch_is_a_function_of_dtype_and_length(dtype, s, chunked):
    assert twkv6.uses_chunked(dtype, s) is chunked
    assert twkv6.CHUNK == 64


def test_chunked_wrapper_refuses_cpu_tensors_and_counts_nothing():
    before = twkv6.launches
    x = torch.zeros((1, 64, 1, 4), dtype=torch.bfloat16)
    u = torch.zeros((1, 4), dtype=torch.bfloat16)
    for fn in (twkv6.wkv6, twkv6.previous_design):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, x, x, x, u)
    assert twkv6.launches == before
