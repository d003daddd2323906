"""The row-norm kernel's route, its plain twin and its wrapper's checks, on
the CPU (no card: the kernel itself is tested in ``test_torch_cuda.py``).

The twin (``ref.rmsnorm_ref`` / ``ref.layernorm_ref``) is the eager
float32 chain the model code ran before the kernel, held here against
that chain written out bit for bit. ``kernel_ops.rownorm`` sends a CPU
tensor (one that needs a gradient too) to the twin and refuses a meta
tensor; ``impl="dense"`` runs the twin without it; ``RownormFn``'s
backward is the twin's gradient; the CUDA wrapper refuses what the
kernel does not take before it looks at the device.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rownorm as rn
from repro_torch.models import layers


def _old_rmsnorm(x, weight, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def _old_layernorm(x, weight, bias, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def _inputs(dtype, w_dtype, shape=(2, 7, 48), seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=g) + 0.5).to(dtype)
    w = (0.1 * torch.randn(shape[-1], generator=g)).to(w_dtype)
    b = (0.1 * torch.randn(shape[-1], generator=g)).to(w_dtype)
    return x, w, b


@pytest.fixture
def no_kernel(monkeypatch):
    """The CUDA wrapper replaced by one that fails the test if reached."""
    def refuse(*args, **kwargs):
        raise AssertionError("the row-norm kernel was reached")

    monkeypatch.setattr(rn, "rownorm", refuse)


DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dtype,w_dtype", DTYPES)
def test_twin_is_the_old_chain_bit_for_bit(dtype, w_dtype, no_kernel):
    x, w, b = _inputs(dtype, w_dtype)
    rms, layer = _old_rmsnorm(x, w), _old_layernorm(x, 1 + w, b)
    for got in (ref.rmsnorm_ref(x, w), ref.rownorm_plain(x, w, eps=1e-6, center=False),
                layers.rmsnorm(x, w), layers.apply_norm(x, {"scale": w}, "rmsnorm")):
        assert got.dtype == dtype and torch.equal(got, rms)
    for got in (ref.layernorm_ref(x, 1 + w, b),
                ref.rownorm_plain(x, 1 + w, b, eps=1e-5, center=True),
                layers.layernorm(x, 1 + w, b),
                layers.apply_norm(x, {"scale": 1 + w, "bias": b}, "layernorm")):
        assert got.dtype == dtype and torch.equal(got, layer)


@pytest.mark.parametrize("center", [False, True], ids=["rms", "layer"])
def test_cpu_tensors_never_reach_the_kernel(center, no_kernel):
    x, w, b = _inputs(torch.bfloat16, torch.bfloat16, shape=(4, 16))
    before = ops.launch_counts()
    got = ops.rownorm(x, w, b if center else None, eps=1e-5, center=center)
    want = (_old_layernorm(x, w, b) if center else _old_rmsnorm(x, w, eps=1e-5))
    assert torch.equal(got, want)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("center", [False, True], ids=["rms", "layer"])
@pytest.mark.parametrize("needs", ["x", "w"])
def test_an_input_that_needs_a_gradient_keeps_the_twin(center, needs, no_kernel):
    x, w, b = _inputs(torch.float32, torch.float32, shape=(3, 5, 24), seed=1)
    (x if needs == "x" else w).requires_grad_(True)
    bias = b if center else None
    got = ops.rownorm(x, w, bias, eps=1e-5, center=center)
    want = _old_layernorm(x, w, b) if center else _old_rmsnorm(x, w, eps=1e-5)
    assert torch.equal(got, want) and got.requires_grad
    leaf = x if needs == "x" else w
    (g_got,) = torch.autograd.grad(got.square().sum(), leaf)
    (g_want,) = torch.autograd.grad(want.square().sum(), leaf)
    assert torch.equal(g_got, g_want)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_dense_impl_runs_the_twin_without_the_kernels_route(kind, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("kernel_ops.rownorm was reached")

    monkeypatch.setattr(ops, "rownorm", refuse)
    x, w, b = _inputs(torch.bfloat16, torch.float32)
    p = {"scale": w, "bias": b}
    got = layers.apply_norm(x, p, kind, "dense")
    want = _old_rmsnorm(x, w) if kind == "rmsnorm" else _old_layernorm(x, w, b)
    assert torch.equal(got, want)
    with pytest.raises(AssertionError, match="reached"):
        layers.apply_norm(x, p, kind, "xla")


def test_a_meta_tensor_is_refused():
    x, w = torch.empty((3, 64), device="meta"), torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.rownorm(x, w, eps=1e-6, center=False)


@pytest.mark.parametrize("center", [False, True], ids=["rms", "layer"])
@pytest.mark.parametrize("needs", ["x", "w", "x+w+b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernel_functions_backward_is_the_twins_gradient(center, needs, dtype,
                                                             monkeypatch):
    """``RownormFn`` with the launch replaced by the twin (no card here):
    one forward a call, and the gradients of exactly the inputs that need
    one, equal bit for bit to autograd's through the twin."""
    calls = []

    def forward(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return ref.rownorm_plain(*args, **kwargs)

    monkeypatch.setattr(rn, "_forward", forward)
    x, w, b = _inputs(dtype, dtype, shape=(3, 5, 24), seed=2)
    bias = b if center else None
    leaves = [t for name, t in (("x", x), ("w", w), ("b", bias))
              if t is not None and name in needs]
    for t in leaves:
        t.requires_grad_(True)
    got = rn.rownorm(x, w, bias, eps=1e-5, center=center)
    assert calls == [False] and got.requires_grad
    want = ref.rownorm_plain(x, w, bias, eps=1e-5, center=center)
    assert torch.equal(got, want)
    g_got = torch.autograd.grad(got.float().square().sum(), leaves)
    g_want = torch.autograd.grad(want.float().square().sum(), leaves)
    assert all(torch.equal(a, e) for a, e in zip(g_got, g_want))
    assert calls == [False]  # the backward launches nothing


@pytest.mark.parametrize("placement", ["rows", "last"])
def test_a_dtensor_runs_on_its_local_rows(placement, tmp_path, no_kernel):
    """On a one-rank gloo mesh: rows sharded stay sharded, a sharded last
    dim is gathered first; the values and w's gradient are the twin's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        x, w, _ = _inputs(torch.float32, torch.float32, shape=(4, 6, 16), seed=3)
        w.requires_grad_(True)
        shard = Shard(1) if placement == "rows" else Shard(2)
        dx = DTensor.from_local(x, mesh, [shard], run_check=False)
        dw = DTensor.from_local(w, mesh, [Replicate()], run_check=False)
        got = ops.rownorm(dx, dw, eps=1e-6, center=False)
        assert isinstance(got, DTensor)
        assert got.placements == ((shard,) if placement == "rows" else (Replicate(),))
        want = _old_rmsnorm(x, w)
        assert torch.equal(got.full_tensor(), want)
        (g_got,) = torch.autograd.grad(got.to_local().sum(), w)
        (g_want,) = torch.autograd.grad(want.sum(), w)
        assert torch.equal(g_got, g_want)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("d", [4, 12, 20, 100, 16392, 32768])
def test_cuda_wrapper_refuses_a_width_it_cannot_take(d):
    x, w = torch.zeros((3, d)), torch.zeros(d)
    with pytest.raises(ValueError, match="multiple of 8"):
        rn.rownorm(x, w, eps=1e-6, center=False)
    with pytest.raises(ValueError, match="multiple of 8"):
        rn.check_shapes(x, w, torch.zeros(d), True)


def test_cuda_wrapper_refuses_other_inputs():
    x, w = torch.zeros((3, 64)), torch.zeros(64)
    before = rn.launches
    with pytest.raises(TypeError, match="float32/bfloat16"):
        rn.rownorm(x.half(), w, eps=1e-6, center=False)
    with pytest.raises(TypeError, match="like w"):
        rn.rownorm(x, w, torch.zeros(64, dtype=torch.bfloat16), eps=1e-5, center=True)
    with pytest.raises(ValueError, match="shape"):
        rn.rownorm(x, torch.zeros(32), eps=1e-6, center=False)
    with pytest.raises(ValueError, match="bias"):
        rn.rownorm(x, w, eps=1e-5, center=True)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rownorm(x, w, eps=1e-6, center=False)
    assert rn.launches == before


@pytest.mark.parametrize("element_size", [2, 4])
def test_plan_covers_every_width_in_whole_warps(element_size):
    """Every width the kernel takes gets a block of whole warps, at most
    ``MAX_THREADS`` of them, holding the row in at most 16 vectors a
    thread; the served width holds two."""
    for d in range(8, rn.MAX_D + 1, 8):
        threads, per = rn.plan(d, element_size)
        nvec = d * element_size // 16
        assert threads % 32 == 0 and 32 <= threads <= rn.MAX_THREADS
        assert threads * per >= nvec and threads * (per - 1) < nvec and per <= 16
        assert rn.plan(d, element_size) == (threads, per)
    assert rn.plan(2048, 2) == (128, 2)
