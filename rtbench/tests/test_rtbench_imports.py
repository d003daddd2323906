"""Nothing the benchmark loads is JAX, flax or the JAX package.

Names are compared whole by their top-level part: ``repro_torch`` (the
port) begins with ``repro`` (the JAX package) and is allowed."""
import subprocess
import sys

import pytest

from rtbench import harness
from rtbench.tests.helpers import HERE


def test_forbidden_names_are_compared_whole(monkeypatch):
    # Other tests in this process may have loaded JAX or the JAX package:
    # compare against what is loaded already.
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_fake_mod", object())
    monkeypatch.setitem(sys.modules, "reprox", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert set(harness.forbidden_modules()) == before | {"repro", "jax"}


RUN = r"""
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from rtbench import harness, spec
from rtbench.tests.helpers import TINY_CHAT, make_bench
import pathlib, tempfile
root = make_bench(pathlib.Path(tempfile.mkdtemp()), [dict(name="g.chat", config="granite-3-2b",
                  traffic="chat", chips=1, why="t")], {{"chat": TINY_CHAT}})
cell = spec.load_cell("g.chat", root=root, bench_dir=root / "rtbench")
harness.run(cell, 5, 1.0, False, "cpu", time.time(), tiny=True)
import rtbench.tools.sweep, rtbench.tools.control, rtbench.reference.models
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "repro"}}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    code = RUN.format(root=str(HERE.parent), src=str(HERE.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_a_run_on_the_card_loads_no_jax():
    """On the card: rtbench/run.py ends with a result line and no JAX."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "granite.chat",
                          "--seed", "7", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("{")


def test_run_refuses_without_the_card(tmp_path):
    """Without CUDA, rtbench/run.py exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "granite.chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=HERE.parent)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_refuses_in_a_folder_without_the_program(tmp_path):
    """Only BENCHMARK.json and rtbench/: no program to measure, no result."""
    import shutil

    shutil.copytree(HERE, tmp_path / "rtbench")
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "rtbench/run.py", "--workload", "granite.chat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
