"""The port's serving entry points on the CPU, through their own argument
parsers: ``launch.serve`` for every arch the engine serves (the zoo less
whisper-large-v3 and qwen2-vl-72b, which it refuses, as the reference's
engine cannot serve them either), and ``launch.serve_multitenant`` in
each of the reference's four topologies (one device with the BATCH-4
line, a live cluster of two slices, the cluster behind the ingest
gateway with camera sources, and behind the datagram transport with a
Chrome trace). Tiny configs, two requests, a few frames; admission on a
wall clock depends on the host's load, so the tests hold what every run
must keep: conservation, zero decode builds, the summary lines.
"""
import json

import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve, serve_multitenant

SERVED = [a for a in ARCHS if a not in serve.MODEL_API_ONLY]


def test_eight_archs_are_served_and_two_refused():
    assert len(SERVED) == 8
    assert set(serve.MODEL_API_ONLY) == {"whisper-large-v3", "qwen2-vl-72b"}
    assert not hasattr(serve, "PORTED_ARCHS")


@pytest.mark.parametrize("arch", SERVED)
def test_serve_launcher_serves_each_arch(arch, capsys):
    m = serve.main(["--archs", arch, "--seq", "8", "--requests", "2", "--frames", "3",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(f"({arch}/8/rt)") == 2 and "admitted" in out
    assert f"completed={m.completed_frames} missed={m.missed_frames}" in out
    assert m.completed_frames + m.dropped_frames + m.lost_frames == m.ingested_frames


@pytest.mark.parametrize("arch", sorted(serve.MODEL_API_ONLY))
def test_serve_launcher_refuses_what_no_engine_serves(arch, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--archs", f"granite-3-2b,{arch}", "--device", "cpu"])
    err = capsys.readouterr().err
    assert arch in err and "reference's engine" in err and "model API" in err


def test_serve_launchers_default_to_the_card(monkeypatch):
    """Both default to the card, and without one they raise rather than
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_multitenant.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="is_available"):
        serve_multitenant.main(["--requests", "1"])


TOPOLOGIES = {
    "single": [],
    "slices": ["--slices", "2"],
    "camera": ["--slices", "2", "--source", "camera"],
    "transport": ["--slices", "2", "--transport"],
}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_multitenant_driver_topologies(topology, tmp_path, capsys):
    argv = ["--device", "cpu", "--seq", "8", "--requests", "2", "--frames", "3",
            *TOPOLOGIES[topology]]
    trace = tmp_path / "trace.json"
    if topology == "transport":
        argv += ["--trace", str(trace)]
    rec = serve_multitenant.main(argv)
    out = capsys.readouterr().out
    assert rec["conserved"], rec
    names = ["device0"] if topology == "single" else ["slice0", "slice1"]
    assert sorted(rec["slices"]) == names
    assert all(s["decode_compiles"] == 0 for s in rec["slices"].values())
    if topology == "single":
        assert "DeepRT : completed=" in out and "BATCH-4: completed=" in out
        assert rec["batch4"]["completed_frames"] == 3 * rec["accepted"]
    else:
        assert "cluster: completed=" in out
    if topology == "camera":
        assert rec["sessions_conserved"] and "ingest : streams=" in out
    if topology == "transport":
        assert rec["wire_conserved"] and "link   : sends=" in out
        assert rec["spans"] > 0 and f"-> {trace}" in out
        assert len(json.loads(trace.read_text())["traceEvents"]) > 0
