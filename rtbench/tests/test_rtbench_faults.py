"""The whole run at tiny size on the CPU, with the timed path broken
underneath the harness: ``correct`` must come out false for each fault a
served cell can have, and true without one. (No cell spans chips, so the
exchange between chips has no fault to plant.)"""
import time

import pytest
import torch

from rtbench import harness, spec
from rtbench.tests.helpers import TINY_CHAT, TINY_PROMPTS, make_bench, steady


def _wrap_dispatch(slices, before=None, after=None):
    for sl in slices.values():
        eng = sl.engine
        inner = eng.dispatch

        def dispatch(mid, shape, batch, kind="prefill", _inner=inner, _eng=eng, **kw):
            if before is not None:
                kw = before(_eng, mid, shape, kind, kw)
            saved = _eng.arena(mid, shape[0]).cur.clone() if kind == "decode" else None
            handle = _inner(mid, shape, batch, kind, **kw)
            if after is not None:
                after(_eng, mid, shape, kind, handle, saved)
            return handle

        eng.dispatch = dispatch


def state_unchanged(slices):
    """Every decode step leaves the arena's cursors where they were: the
    step's state does not advance."""
    def after(eng, mid, shape, kind, handle, saved):
        if kind == "decode":
            eng.arena(mid, shape[0]).cur.copy_(saved)
    _wrap_dispatch(slices, after=after)


def half_the_batch(slices):
    """Half of each job's rows are left out: decode rows not stepped,
    prompt rows zeroed."""
    def before(eng, mid, shape, kind, kw):
        if kind == "decode" and kw.get("step_rows"):
            rows = list(kw["step_rows"])
            kw = dict(kw, step_rows=rows[: len(rows) // 2],
                      payload={r: t for r, t in (kw.get("payload") or {}).items()
                               if r in rows[: len(rows) // 2]} or None)
        elif kind == "prefill" and isinstance(kw.get("payload"), list):
            rows = kw["payload"]
            kw = dict(kw, payload=[r if i < len(rows) // 2 else r * 0
                                   for i, r in enumerate(rows)])
        return kw
    _wrap_dispatch(slices, before=before)


def answer_altered(slices):
    """Each prompt's next token is altered where the engine produces it,
    and each decode step's logits are rolled by one token."""
    def after(eng, mid, shape, kind, handle, saved):
        v = eng.configs[mid].vocab_size
        if kind == "prefill":
            handle.outputs = (handle.outputs + 1) % v
        else:
            handle.outputs = torch.roll(handle.outputs, 1, dims=-1)
    _wrap_dispatch(slices, after=after)


CELLS = [dict(name="g.chat", config="granite-3-2b", traffic="chat", chips=1, why="t"),
         dict(name="r.prompts", config="rwkv6-1.6b", traffic="prompts", chips=1, why="t")]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make_bench(tmp_path_factory.mktemp("faults"), CELLS,
                      {"chat": TINY_CHAT, "prompts": TINY_PROMPTS})


def _run(bench, cell, fault=None, seed=2**31 + 3):
    c = spec.load_cell(cell, root=bench, bench_dir=bench / "rtbench")
    return harness.run(c, seed, 3.0, False, "cpu", time.time(), tiny=True,
                       fault=lambda slices: steady(slices, fault))


@pytest.mark.parametrize("cell", ["g.chat", "r.prompts"])
def test_sound_run_is_correct(bench, cell):
    out = _run(bench, cell)
    assert out["line"]["correct"] is True, out["line"]["compared"]
    assert out["line"]["attempted"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("g.chat", state_unchanged),
    ("g.chat", half_the_batch),
    ("g.chat", answer_altered),
    ("r.prompts", half_the_batch),
    ("r.prompts", answer_altered),
])
def test_fault_makes_the_run_incorrect(bench, cell, fault):
    out = _run(bench, cell, fault)
    assert out["line"]["correct"] is False, out["line"]["compared"]
