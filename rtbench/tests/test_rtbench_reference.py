"""The plain reference against the port's models on the same weights.

The test imports the port; the reference does not (see
``test_rtbench_imports.py``)."""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import tiny
from repro_torch.models import model_for
from rtbench import spec
from rtbench.harness import dims_of
from rtbench.reference import models, weights

ARCHS = [("granite-3-2b", "attn"), ("rwkv6-1.6b", "rwkv")]


def _setup(arch, family, seed=3):
    cfg = tiny(arch)
    dims = dims_of(dataclasses.asdict(cfg))
    return cfg, dims, weights.make(spec.family(family), dims, seed, "cpu", torch.float32)


@pytest.mark.parametrize("arch,family", ARCHS)
def test_tree_matches_the_ports_parameters(arch, family):
    cfg, _, tree = _setup(arch, family)
    spec = model_for(cfg).abstract_params(torch.float32)

    def shapes(t, prefix=()):
        if isinstance(t, dict):
            return {k: v for key, sub in t.items() for k, v in shapes(sub, prefix + (key,)).items()}
        if isinstance(t, list):
            return {k: v for i, sub in enumerate(t) for k, v in shapes(sub, prefix + (i,)).items()}
        return {prefix: tuple(t.shape)}

    assert shapes(tree) == shapes(spec)


@pytest.mark.parametrize("arch,family", ARCHS)
def test_forward_matches_the_port(arch, family):
    cfg, dims, tree = _setup(arch, family)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port, _ = model_for(cfg).forward(tree, toks)
    ref = models.logits(tree, models.hidden(spec.family(family), tree, toks, dims))
    assert torch.allclose(port, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch,family", ARCHS)
def test_decode_steps_match_the_full_forward(arch, family):
    """The port's decode through its cache, token by token, against the
    reference's one causal pass: what the check relies on."""
    cfg, dims, tree = _setup(arch, family, seed=5)
    m = model_for(cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 12), generator=torch.Generator().manual_seed(1))
    cache = m.init_cache(1, 16, device="cpu")
    steps = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = m.decode_step(tree, cache, toks[:, t], torch.tensor([t], dtype=torch.int32))
            steps.append(lg[0])
    ref = models.logits(tree, models.hidden(spec.family(family), tree, toks, dims))[0]
    assert torch.allclose(torch.stack(steps), ref, atol=2e-5, rtol=0)


def test_weights_repeat_from_the_seed_and_differ_across_seeds():
    _, dims, a = _setup("granite-3-2b", "attn", seed=2**31 + 7)
    _, _, b = _setup("granite-3-2b", "attn", seed=2**31 + 7)
    _, _, c = _setup("granite-3-2b", "attn", seed=2**31 + 8)
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])


def test_control_rounding_departs_from_float32():
    t = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    q = models.fp8_convert(t)
    rel = ((q - t).abs().max() / t.abs().max()).item()
    assert 1e-3 < rel < 0.1
