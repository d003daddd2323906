"""Every architecture of the zoo in the port against the JAX package, at
tiny sizes on the CPU: the port's counterpart of ``tests/test_arch_smoke.py``.

Per arch, on the reference's own parameters (``model.init``) carried
through ``repro_torch.interop`` and ``tests/test_torch_training.py``'s
seed-0 batches:

- forward logits (and MoE aux) against the reference's forward at 2e-3
  (``test_model_pallas_matches_xla``);
- the port's decode steps against its own forward at 5e-3, as the
  reference checks its own (MoE at a drop-free capacity factor 8).

The loss and every gradient leaf of all ten archs against
``jax.value_and_grad`` are ``tests/test_torch_training.py``'s
``test_loss_and_every_gradient_match_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import tiny as jtiny
from repro.models import model_for as jmodel_for
from repro_torch import interop
from repro_torch.configs.registry import ARCHS, tiny
from repro_torch.models import model_for
from test_torch_training import ARCHS as TRAINED_ARCHS
from test_torch_training import _batch

ALL_ARCHS = list(ARCHS)
KEY = jax.random.PRNGKey(0)


def _jax_args(inp):
    if "frames" in inp:
        return jnp.asarray(inp["frames"]), jnp.asarray(inp["dec_tokens"])
    pos = inp.get("positions")
    return jnp.asarray(inp["tokens"]), None if pos is None else jnp.asarray(pos)


def _port_args(inp):
    if "frames" in inp:
        return torch.from_numpy(inp["frames"]), torch.from_numpy(inp["dec_tokens"])
    pos = inp.get("positions")
    return torch.from_numpy(inp["tokens"]), None if pos is None else torch.from_numpy(pos)


def _pair(arch, **overrides):
    """(JAX model, JAX params, port model, port params) on one draw."""
    jm = jmodel_for(jtiny(arch, **overrides))
    jp = jm.init(KEY)
    tp = interop.params_from_numpy(tiny(arch, **overrides), jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jm, jp, model_for(tiny(arch, **overrides)), tp


def test_the_zoo_is_the_references():
    assert ALL_ARCHS == list(JARCHS) and len(ALL_ARCHS) == 10
    assert sorted(TRAINED_ARCHS) == sorted(ALL_ARCHS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    inp = _batch(arch)
    jl, jaux = jm.forward(jp, *_jax_args(inp))
    with torch.no_grad():
        tl, taux = tm.forward(tp, *_port_args(inp))
    b, s = inp["dec_tokens" if "frames" in inp else "tokens"].shape
    assert tuple(tl.shape) == (b, s, tiny(arch).vocab_size)
    assert bool(torch.isfinite(tl).all()) and bool(torch.isfinite(taux))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(float(taux), float(jaux), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_matches_forward(arch):
    _, _, tm, tp = _pair(arch, moe_capacity_factor=8.0)
    inp = _batch(arch)
    if "positions" in inp:
        # On text positions, as the reference's own test: the forward's
        # causal mask runs over token order, the decode step's over the
        # cache's positions, and the two agree only where those are one.
        b, s = inp["tokens"].shape
        inp["positions"] = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    errs = []
    with torch.no_grad():
        if "frames" in inp:
            frames, toks = _port_args(inp)
            b, s = toks.shape
            full, _ = tm.forward(tp, frames, toks)
            cache = tm.encode_for_decode(tp, frames,
                                         tm.init_cache(b, s, frames.shape[1], device="cpu"))
            for t in range(s):
                cur = torch.full((b,), t, dtype=torch.int32)
                lg, cache = tm.decode_step(tp, cache, toks[:, t], cur)
                errs.append(float((lg - full[:, t]).abs().max()))
        else:
            toks, pos = _port_args(inp)
            b, s = toks.shape
            full, _ = tm.forward(tp, toks, pos)
            cache = tm.init_cache(b, s, device="cpu")
            for t in range(s):
                cur = torch.full((b,), t, dtype=torch.int32)
                mp = pos[:, :, t:t + 1] if pos is not None else None
                lg, cache = tm.decode_step(tp, cache, toks[:, t], cur, mp)
                errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 5e-3, f"decode/forward divergence {max(errs)}"
