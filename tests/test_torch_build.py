"""The kernels' build rule and the flash backward's route rule, on the CPU.

``_build.target`` names a kernel's library by a hash of its source, of
every shared header under ``csrc/`` and of the flags, so an edited header
rebuilds the libraries that include it instead of loading a stale one.
``flash_attention_bwd.route`` is the backward's rule by dtype and head
dim (the card's dispatch is held against it in ``test_torch_cuda.py``);
``previous_design`` refuses CPU tensors like the kernel's own wrapper.
No ``nvcc`` is needed: nothing here compiles.
"""
import shutil

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ops


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that the build module reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    return copy


def test_shared_header_exists_and_is_included_by_both_attention_kernels():
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert "wgmma_tiles.cuh" in headers
    for name in ("flash_attention", "flash_attention_bwd"):
        assert '#include "wgmma_tiles.cuh"' in (_build.CSRC / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", _build.KERNELS)
def test_target_changes_when_a_shared_header_changes(csrc, name):
    before = _build.target(name)
    assert before.parent == _build.BUILD and before.name.startswith(f"{name}-")
    assert _build.target(name) == before  # a pure function of the files
    header = csrc / "wgmma_tiles.cuh"
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    assert _build.target(name) != before
    header.write_text(text)
    assert _build.target(name) == before
    extra = csrc / "extra.cuh"  # a new header counts too
    extra.write_text("#pragma once\n")
    assert _build.target(name) != before


def test_target_changes_with_its_own_source_only(csrc):
    bwd = _build.target("flash_attention_bwd")
    wkv = _build.target("wkv6")
    src = csrc / "flash_attention_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.target("flash_attention_bwd") != bwd
    assert _build.target("wkv6") == wkv


@pytest.mark.parametrize("d", [8, 16, 64, 96, 128])
def test_backward_route_bf16_up_to_128_is_wgmma(d):
    assert fb.route(torch.bfloat16, d) == "wgmma"
    assert fb.route(torch.float32, d) == "fma"


@pytest.mark.parametrize("d", [136, 192, 256])
def test_backward_route_bf16_past_128_is_mma_sync_and_float32_refused(d):
    # The wide wgmma route took over bf16 at 128 < D <= 256 from mma.sync.
    assert fb.route(torch.bfloat16, d) == "wgmma_wide"
    with pytest.raises(ValueError):
        fb.route(torch.float32, d)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 12), (torch.bfloat16, 264),
                                     (torch.float16, 64), (torch.float32, 0)])
def test_backward_route_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError):
        fb.route(dtype, d)


def test_previous_design_refuses_cpu_tensors_and_counts_nothing():
    q = torch.zeros((1, 64, 4, 64))
    k = torch.zeros((1, 64, 2, 64))
    lse = torch.zeros((1, 4, 64))
    before = ops.launch_counts()["flash_attention_bwd"]
    for fn in (fb.flash_attention_bwd, fb.previous_design):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, k, q, q, lse)
    assert ops.launch_counts()["flash_attention_bwd"] == before
