"""The control, kept at a size a test run can hold: the reference put in
the program's place with its weights rounded through float8 must fail
the limit that the program's own runs meet (tiny configs, float32)."""
import time

import pytest

from rtbench import harness, spec
from rtbench.tests.helpers import TINY_CHAT, TINY_PROMPTS, make_bench, steady


@pytest.mark.parametrize("cell,mix,config", [
    ("g.chat", TINY_CHAT, "granite-3-2b"),
    ("r.prompts", TINY_PROMPTS, "rwkv6-1.6b"),
])
def test_control_fails_where_the_program_passes(tmp_path, cell, mix, config):
    root = make_bench(tmp_path, [dict(name=cell, config=config, traffic="m", chips=1, why="t")],
                      {"m": mix})
    c = spec.load_cell(cell, root=root, bench_dir=root / "rtbench")
    out = harness.run(c, 2**31 + 21, 3.0, False, "cpu", time.time(), tiny=True, control=True,
                      fault=steady)
    limits = c.config_spec()["tiny"]["check"]["limits"]
    numbers = out["extra"]["numbers"]
    assert out["line"]["correct"] is True
    assert set(numbers) == ({"prefill_gap", "decode_gap"} if cell == "g.chat" else {"prefill_gap"})
    assert all(got["value"] <= limits[name] for name, got in numbers.items())
    # The control has to fail one of the cell's numbers, not each.
    assert any(got["control"] > limits[name] for name, got in numbers.items()), numbers
